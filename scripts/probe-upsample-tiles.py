#!/usr/bin/env python3
"""Time the tile shapes upsample_finish and upsample_head could take on the
tiled core, side by side on one NVIDIA card, to choose dispatch_shuffle's
(lvae_tpu_torch/csrc/trunk.cu).

    python3 scripts/probe-upsample-tiles.py [out.json]

Builds the port's kernels (lvae_tpu_torch/ops/build.py) and, beside them,
one more library from a copy of csrc/trunk.cu with probe entry points
appended: both stores (StoreShuffleStaged, the float16 finish and the
head's two float32 tensors) on each tile of TILES (BM x BN outputs a block,
TM x TN a thread, MINB blocks an SM asked of the register allocator), with
16-byte copies; and upsample_finish with the direct store, the design the
staged one was chosen over (StoreShuffleDirect: each thread's outputs
stored from its registers at their shuffled addresses, StoreBias's way),
on dispatch_shuffle's tiles. Then, on random inputs at the main path's
shapes (photo1: qarv_base's tail, C = 128; qres34m's, C = 192; the lossless
head, C = 192, N = 96; the B = 6 batch's qarv_base tail), with CUDA-graph
device times
(chip_smoke.graph_ms, median of 5 replays of 10 calls, every design timed
twice in turns A B .. B A): the main entry, its chain (the oracle), the
direct store (upsample_finish's cases), the product alone (dense on the same
operands, float32 out, unshuffled) and every tile, each bitwise against
the main entry. Prints the card's name and power limit, then one JSON
object (also written to out.json when given).
"""
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from lvae_tpu_torch.ops import build, trunk  # noqa: E402

# (BM, BN, TM, TN, MINB): dispatch_shuffle's two tiles at N % 48 == 0
# first, then fewer outputs a thread (more warps an SM), more threads a
# block, a register cap
TILES = ((64, 48, 4, 6, 1), (32, 48, 4, 6, 1), (32, 48, 2, 6, 1),
         (64, 48, 4, 3, 1), (64, 48, 2, 6, 1), (128, 48, 4, 6, 1),
         (32, 48, 2, 3, 1), (64, 48, 4, 6, 2), (96, 48, 6, 6, 1))

PROBE_SOURCE = r'''
// ---- probe entry points (scripts/probe-upsample-tiles.py) ----
// upsample_finish's other store: each thread writes its own outputs from
// its registers at their shuffled addresses (two divisions an output)
struct StoreShuffleDirect {
    __half* out; const float* b; int W, r;
    __device__ void operator()(int m, int n, float acc) const {
        const int L = 3 * r, t = m / W, c = n / (r * r),
                  ij = n - c * r * r, i = ij / r, j = ij - i * r;
        out[((long long)t * r + i) * L * W + (long long)(m - t * W) * L
            + j * 3 + c] = __float2half_rn(finish_value(acc + b[n]));
    }
};

extern "C" int probe_upsample_direct(const void* x, int M, int W, int C,
                                     int rate, const void* wt, const void* b,
                                     void* out, int device, void* stream) {
    TRY(set_device(device));
    return (int)dispatch_shuffle_rows(
        x_f(x), M, 3 * rate * rate, C, x_f(wt),
        StoreShuffleDirect{(__half*)out, x_f(b), W, rate},
        (cudaStream_t)stream);
}

template <class T, class Store>
static int probe_shuffle(const void* x, int M, int K, const void* wt,
                         Store st, cudaStream_t s) {
    const DenseSrc src{x_f(x), M, K};
    return (int)launch_tiled<T, 4>(M, st.N, K, src, x_f(wt), st, s);
}

extern "C" int probe_upsample(const void* x, int M, int W, int C, int rate,
                              const void* wt, const void* b, void* out0,
                              void* out1, int head, int tile, int device,
                              void* stream) {
    TRY(set_device(device));
    if (C % 4 != 0 || !aligned16(x) || !aligned16(wt))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const StoreShuffleStaged<false> sh{(float*)out0, (float*)out1, x_f(b), M,
                                       6 * rate * rate, W, rate};
    const StoreShuffleStaged<true> sf{(__half*)out0, nullptr, x_f(b), M,
                                      3 * rate * rate, W, rate};
#define PROBE_TILE(i, ...)                                                 \
    case i:                                                               \
        return head ? probe_shuffle<Tile<__VA_ARGS__>>(x, M, C, wt, sh, s) \
                    : probe_shuffle<Tile<__VA_ARGS__>>(x, M, C, wt, sf, s);
    switch (tile) {
%(cases)s
        default: return (int)cudaErrorInvalidValue;
    }
#undef PROBE_TILE
}
'''

PROBE_DIR = build.BUILD_DIR / 'probe_upsample'
PROBE_LIB = PROBE_DIR / 'libprobe.so'


def probe_source():
    cases = '\n'.join(f'        PROBE_TILE({i}, {bm}, {bn}, {tm}, {tn}, {mb})'
                      for i, (bm, bn, tm, tn, mb) in enumerate(TILES))
    return PROBE_SOURCE.replace('%(cases)s', cases)


def build_probe():
    """Compile trunk.cu with the probe entry appended into PROBE_LIB; ->
    ptxas's registers and spills of the probe's kernels."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    src = PROBE_DIR / 'trunk_probe.cu'
    src.write_text((build._PKG / 'csrc' / 'trunk.cu').read_text()
                   + probe_source())
    res = subprocess.run([build.nvcc_path(), *build._FLAGS, '-Xptxas', '-v',
                          '-shared', str(src), '-o', str(PROBE_LIB)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'probe build failed:\n{res.stderr}')
    lines = res.stderr.splitlines()
    return [' | '.join(x.strip() for x in lines[i:i + 4])
            for i, a in enumerate(lines)
            if 'StoreShuffleStaged' in a and 'Compiling entry' in a]


def probe_library():
    lib = ctypes.CDLL(str(PROBE_LIB))
    lib.probe_upsample.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.probe_upsample_direct.argtypes = build._SIGNATURES[
        'trunk_upsample_finish']
    return lib


def on_tile(lib, tile, head):
    """upsample_finish (head False) or upsample_head through the probe's
    tile `tile`, on the main entry's arguments."""
    def run(x, *args):
        rate = args[-1]
        B, H, W, C = x.shape
        if head:
            wt, b = trunk._head_operands(*args[:4])
        else:
            wt, b = trunk._out_major(args[0]), args[1]
        outs = [torch.empty((B, rate * H, rate * W, 3),
                            dtype=torch.float32 if head else torch.float16,
                            device=x.device) for _ in range(1 + head)]
        trunk._launch('probe_upsample', lib.probe_upsample, x.data_ptr(),
                      B * H * W, W, C, rate, wt.data_ptr(), b.data_ptr(),
                      outs[0].data_ptr(), outs[-1].data_ptr(), int(head),
                      tile, device=x.device)
        return tuple(outs) if head else outs[0]
    return run


def direct_store(lib):
    """upsample_finish through the direct store."""
    def run(x, w, b, rate):
        return trunk._upsample_finish_launch(lib.probe_upsample_direct, x, w,
                                             b, rate)
    return run


def product_alone(x, w, b, *rest):
    """dense on the same operands (the mean's conv for the head, both
    widths as one product there): the product without the finish, the
    float16 rounding or the shuffle."""
    B, H, W, C = x.shape
    if len(rest) == 3:                   # the head: (w_scale, b_scale, rate)
        w = torch.cat([w, rest[0]], 1)
        b = torch.cat([b, rest[1]])
    return trunk._dense_launch(x.reshape(B, H * W, C), w, b)


def in_turns(fns, args):
    """{name: [ms, ms]}: each design's graph_ms twice, in turns A B .. B A."""
    order = list(fns) + list(reversed(fns))
    out = {k: [] for k in fns}
    for k in order:
        out[k].append(chip_smoke.graph_ms(
            torch, lambda: fns[k](*args), chip_smoke.TRUNK_INNER))
    return out


def main():
    if not torch.cuda.is_available():
        print('probe: no CUDA device', file=sys.stderr)
        return 1
    device = torch.device('cuda')
    with ThreadPoolExecutor(2) as pool:
        main_build = pool.submit(build.build)
        ptxas = pool.submit(build_probe)
        info = main_build.result()
        ptxas = ptxas.result()
    build.library()
    plib = probe_library()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = dict(card=smi, build_s=info['seconds'], ptxas=ptxas,
               tiles=[list(t) for t in TILES], cases={})
    g = torch.Generator(device=device).manual_seed(chip_smoke.SHUFFLE_SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=device) * scale

    cases = {'qarv_base tail': ('upsample_finish', 1, 128),
             'qres34m tail': ('upsample_finish', 1, 192),
             'lossless head': ('upsample_head', 1, 192),
             'qarv_base tail, B = 6': ('upsample_finish', 6, 128)}
    for label, (name, B, C) in cases.items():
        head = name == 'upsample_head'
        args = [randn(B, 128, 192, C)]
        for _ in range(1 + head):
            # a (C, N) view of an out-major weight, as the model passes it
            args += [randn(48, C, scale=C ** -0.5).t(), randn(48, scale=0.1)]
        args.append(4)
        fns = {'main': getattr(trunk, name),
               'chain': getattr(trunk, name + '_chain'),
               'product_alone': product_alone}
        if not head:
            fns['direct_store'] = direct_store(plib)
        fns.update((f'tile{i}', on_tile(plib, i, head))
                   for i in range(len(TILES)))
        want = fns['main'](*args)
        want = want if head else (want,)
        same = {}
        for k, fn in fns.items():
            if k == 'product_alone':
                continue
            got = fn(*args)
            got = got if head else (got,)
            same[k] = all(chip_smoke.same_bits(torch, a, b)
                          for a, b in zip(got, want))
        res['cases'][label] = dict(
            kernel=name, shape=list(args[0].shape), bitwise=same,
            ms=in_turns(fns, args))
        if not all(same.values()):
            raise SystemExit(f'{label}: designs differ: {same}')
    print(smi, flush=True)
    print(json.dumps(res), flush=True)
    if len(sys.argv) > 1:
        os.makedirs(os.path.dirname(sys.argv[1]) or '.', exist_ok=True)
        with open(sys.argv[1], 'w') as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
