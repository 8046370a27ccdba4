#!/usr/bin/env python3
"""Write the golden portable streams that chip_smoke.py decodes in every
run (tests/golden/), on one NVIDIA card.

    python3 scripts/write-golden-streams.py --tree PARENT --commit SHA \
        --out tests/golden

Run it only from an unpacked copy of the parent commit (``git archive SHA``
into a git-ignored directory, its checkpoint copied in), never to make a
failing golden check pass: the files pin what a portable stream written by
an earlier commit decodes to, and a change that moves those bits is a
fault of the change. ``--tree`` is that copy; the streams are written with
its ``lvae_tpu_torch`` and its ``chip_smoke.py`` (the same models, weights
and settings as the checks there):

- ``qarv_base_photo1_lmb2048.bits``: qarv_base with the committed weights
  (checkpoints/qarv_base_mixed20k_ema_f16.msgpack), images/photo1_512x768.png
  at lambda 2048, num_lanes='auto', compress_file (portable);
- ``qres34m_lossless_crop256.bits``: qres34m_lossless with the seeded random
  weights of chip_smoke.build_qres34m, on the 256 x 256 top-left crop of
  photo1 (chip_smoke.SPREAD_CROP), N = 128, esc_cap 1 << 21, in
  compress_file's container;
- ``golden.json``: each file's sha256 and the sha256 of what
  decompress_file gives back (the float16 image; the uint8 pixels, which
  must equal the crop's), the card's name and power limit, the driver,
  nvcc, torch and its CUDA, and the commit.

Each stream is decoded once in the writing process and must equal the
encode side's reconstruction (compress_check), or nothing is written.
"""
import argparse
import hashlib
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np

QARV_FILE = 'qarv_base_photo1_lmb2048.bits'
LOSSLESS_FILE = 'qres34m_lossless_crop256.bits'
QARV_LMB = 2048.0


def sha256(data):
    return hashlib.sha256(data).hexdigest()


def image_bytes(rec):
    """decompress_file's float32 image -> the float16 bytes it came from."""
    half = rec.astype(np.float16)
    assert np.array_equal(half.astype(np.float32), rec)
    return np.ascontiguousarray(half).tobytes()


def pixel_bytes(rec):
    """A lossless model's u8 / 255 float32 image -> its uint8 bytes."""
    u8 = np.rint(rec * 255.0).astype(np.uint8)
    assert np.array_equal(u8.astype(np.float32) / 255.0, rec)
    return np.ascontiguousarray(u8).tobytes()


def card_versions(torch, build):
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit,driver_version',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, power, driver = (s.strip() for s in smi.split(','))
    nvcc = subprocess.run([build.nvcc_path(), '--version'],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()
    return dict(name=name, power_limit=power, driver_version=driver,
                nvcc_release=next(l for l in nvcc if 'release' in l),
                torch=torch.__version__, cuda=torch.version.cuda)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tree', required=True,
                    help='unpacked copy of the parent commit')
    ap.add_argument('--commit', required=True, help='its sha')
    ap.add_argument('--out', required=True, help='output directory')
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    out = os.path.abspath(args.out)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    if not torch.cuda.is_available():
        print('write-golden-streams: no CUDA device', file=sys.stderr)
        return 1
    import chip_smoke as cs
    import lvae_tpu_torch
    from lvae_tpu_torch.ops import build
    from lvae_tpu_torch.utils import coding

    t = time.perf_counter()
    info = build.build()
    build.library()
    print(json.dumps({'build': info}), flush=True)
    os.makedirs(out, exist_ok=True)
    streams = {}

    # qarv_base, photo1 at lambda 2048 through compress_file (portable)
    model = lvae_tpu_torch.get_model('qarv_base', pretrained=cs.CHECKPOINT)
    model.compress_mode(num_lanes='auto')
    path = os.path.join(out, QARV_FILE)
    model.compress_file(cs.PHOTO, path, lmb=QARV_LMB)
    rec = model.decompress_file(path)
    im = coding.read_png(cs.PHOTO).astype(np.float32)[None] / 255.0
    _, recon = model.compress_check(im, lmb=QARV_LMB, portable=True)
    assert np.array_equal(rec, recon), 'qarv_base: decode != encode side'
    with open(path, 'rb') as f:
        streams['qarv_base'] = dict(
            file=QARV_FILE, file_sha256=sha256(f.read()), model='qarv_base',
            weights=os.path.relpath(cs.CHECKPOINT, tree),
            image=os.path.relpath(cs.PHOTO, tree), lmb=QARV_LMB,
            num_lanes='auto', portable=True,
            output=f'float16 {list(rec.shape)}',
            output_sha256=sha256(image_bytes(rec)))
    del model
    torch.cuda.empty_cache()

    # qres34m_lossless, the 256 x 256 crop of photo1, default random weights
    model = cs.build_qres34m(torch, 'qres34m_lossless')
    model.compress_mode(portable=True, num_lanes=cs.QRES_LANES,
                        esc_cap=cs.LOSSLESS_ESC_CAP)
    n = cs.SPREAD_CROP
    u8 = np.ascontiguousarray(coding.read_png(cs.QRES_PHOTOS[0])[:n, :n])
    crop = u8.astype(np.float32)[None] / 255.0
    obj, recon = model.compress_check(crop)
    obj.append((n, n))                      # compress_file's container
    path = os.path.join(out, LOSSLESS_FILE)
    with open(path, 'wb') as f:
        pickle.dump(obj, file=f)
    rec = model.decompress_file(path)
    assert np.array_equal(rec, recon), 'lossless: decode != encode side'
    assert pixel_bytes(rec) == u8[None].tobytes(), 'lossless: not exact'
    with open(path, 'rb') as f:
        streams['qres34m_lossless'] = dict(
            file=LOSSLESS_FILE, file_sha256=sha256(f.read()),
            model='qres34m_lossless',
            weights=f'chip_smoke.build_qres34m: flax-style init from a torch '
                    f'CPU generator seeded {cs.QRES_SEED}, prior.c4 redrawn',
            image=os.path.relpath(cs.QRES_PHOTOS[0], tree),
            crop=[n, n], num_lanes=cs.QRES_LANES,
            esc_cap=cs.LOSSLESS_ESC_CAP, portable=True,
            output=f'uint8 {list(rec.shape)}',
            output_sha256=sha256(pixel_bytes(rec)),
            pixels_sha256=sha256(u8[None].tobytes()))

    record = dict(
        written_by='scripts/write-golden-streams.py', commit=args.commit,
        card=card_versions(torch, build), streams=streams,
        seconds=time.perf_counter() - t)
    with open(os.path.join(out, 'golden.json'), 'w') as f:
        json.dump(record, f, indent=1)
        f.write('\n')
    print(json.dumps(record), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
