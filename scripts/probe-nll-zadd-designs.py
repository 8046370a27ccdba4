#!/usr/bin/env python3
"""Time the designs nll_head and zadd_dense could take, side by side on one
NVIDIA card, to choose between them (lvae_tpu_torch/csrc/trunk.cu).

    python3 scripts/probe-nll-zadd-designs.py [out.json]

Builds the port's kernels (lvae_tpu_torch/ops/build.py) and, beside them,
one more library from a copy of csrc/trunk.cu with probe entry points
appended: zadd_dense on dispatch_junction's tiles and on dispatch_tiled's,
and nll_head's search in variants (NLL_DESIGNS: four elements a thread or
one, the grid, the next elements loaded before this one's math) and its
floors (NLL_FLOORS: without the element math, without the search, a bare
copy). Then, with CUDA-graph device times (chip_smoke.graph_ms, median of
5 replays of 10 calls, each design timed twice in turns A B .. B A):
- zadd_dense at qres34m's z_proj_0 shape (M = 96 rows an image, Z = 16,
  CO = 48; the weight a .t() view, as the model passes it) at B = 1, 2
  and 4: the old core, both tile choices and the main entry, all bitwise;
- nll_head at photo1's (1, 512, 768, 3) on chip_smoke's synthetic inputs:
  the main kernel (16-byte path; on unaligned views the one-element path),
  the linear count and every design of NLL_DESIGNS, all bitwise; the
  floors once each; and cuobjdump's SASS of the nll_head kernels, counted
by opcode.
Prints the card's name and power limit, then one JSON object (also written
to out.json when given).
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

PROBE_SOURCE = r'''
// ---- probe entry points (scripts/probe-nll-zadd-designs.py) ----
// nll_head's search over the table in shared memory, V elements a thread
// (1, 2 or 4), in a grid-stride loop. MODE bits: PREFETCH (1) loads the
// next iteration's elements before this one's search; NO_MATH (2) skips
// the element math (pm = m, scale = r) and NO_SEARCH (4) the search (index
// 0): the floors of what is left; UNROLL (8) unrolls the steps over a
// depth of at most 10 with a uniform guard; CLAMP (16) loads every probe
// (at entry min(j, S - 1) - 1) and selects, no predicated load.
template <int V, int MODE, int MINB>
__global__ void __launch_bounds__(256, MINB)
nll_probe_kernel(const float* __restrict__ m, const float* __restrict__ r,
                 long long nv, const float* __restrict__ table, int S,
                 float bin_size, float log_bin, float* __restrict__ pm,
                 int* __restrict__ idx) {
    constexpr bool PREFETCH = MODE & 1, MATH = !(MODE & 2),
                   SEARCH = !(MODE & 4), UNROLL = MODE & 8, CLAMP = MODE & 16;
    extern __shared__ float tb[];
    for (int i = threadIdx.x; i < S; i += blockDim.x) tb[i] = table[i];
    __syncthreads();
    const int cap = S - 1;
    const int top = cap ? 1 << (31 - __clz(cap)) : 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    float mv[V], rv[V];
    auto load = [&](long long at) {
        if constexpr (V == 4) {
            const float4 a = reinterpret_cast<const float4*>(m)[at];
            const float4 c = reinterpret_cast<const float4*>(r)[at];
            mv[0] = a.x; mv[1] = a.y; mv[2] = a.z; mv[3] = a.w;
            rv[0] = c.x; rv[1] = c.y; rv[2] = c.z; rv[3] = c.w;
        } else if constexpr (V == 2) {
            const float2 a = reinterpret_cast<const float2*>(m)[at];
            const float2 c = reinterpret_cast<const float2*>(r)[at];
            mv[0] = a.x; mv[1] = a.y;
            rv[0] = c.x; rv[1] = c.y;
        } else {
            mv[0] = m[at];
            rv[0] = r[at];
        }
    };
    auto probe = [&](int step, int* pos, const float* pv) {
#pragma unroll
        for (int q = 0; q < V; ++q) {
            const int j = pos[q] + step;
            if constexpr (CLAMP) {
                const float t = tb[min(j, cap) - 1];
                pos[q] = j <= cap && t < pv[q] ? j : pos[q];
            } else {
                pos[q] = j <= cap && tb[j - 1] < pv[q] ? j : pos[q];
            }
        }
    };
    if (PREFETCH && e < nv) load(e);
    for (; e < nv; e += stride) {
        if (!PREFETCH) load(e);
        float out[V], pv[V];
        int pos[V];
#pragma unroll
        for (int q = 0; q < V; ++q) {
            out[q] = MATH ? nll_mean(mv[q], bin_size) : mv[q];
            pv[q] = MATH ? nll_scale(rv[q], log_bin, tb[0]) : rv[q];
            pos[q] = 0;
        }
        if (PREFETCH && e + stride < nv) load(e + stride);
        if constexpr (SEARCH && UNROLL) {
#pragma unroll
            for (int d = 9; d >= 0; --d)
                if ((1 << d) <= top) probe(1 << d, pos, pv);
        } else if constexpr (SEARCH) {
            for (int step = top; step > 0; step >>= 1) probe(step, pos, pv);
        }
        if constexpr (V == 4) {
            reinterpret_cast<float4*>(pm)[e] =
                make_float4(out[0], out[1], out[2], out[3]);
            reinterpret_cast<int4*>(idx)[e] =
                make_int4(pos[0], pos[1], pos[2], pos[3]);
        } else if constexpr (V == 2) {
            reinterpret_cast<float2*>(pm)[e] = make_float2(out[0], out[1]);
            reinterpret_cast<int2*>(idx)[e] = make_int2(pos[0], pos[1]);
        } else {
            pm[e] = out[0];
            idx[e] = pos[0];
        }
    }
}

// variant: an index of NLL_VARIANTS (the cases below, generated from it);
// blocks 0: elementwise_blocks; threads a block
extern "C" int probe_nll_head(const void* p_mean, const void* p_scale_raw,
                              long long n, const void* table, int S,
                              float bin_size, float log_bin, void* pm,
                              void* idx, int variant, int blocks,
                              int threads, int device, void* stream) {
    TRY(set_device(device));
    const cudaStream_t st = (cudaStream_t)stream;
#define NLL_PROBE(VV, MO, MB)                                                 \
    do {                                                                      \
        if (n % VV != 0) return (int)cudaErrorInvalidValue;                  \
        const long long nv = n / VV;                                         \
        const unsigned grid = blocks > 0 ? (unsigned)blocks                  \
            : (unsigned)((nv + threads - 1) / threads < 4096                 \
                         ? (nv + threads - 1) / threads : 4096);             \
        nll_probe_kernel<VV, MO, MB><<<grid, threads, S * sizeof(float),     \
                                       st>>>(                                \
            x_f(p_mean), x_f(p_scale_raw), nv, x_f(table), S, bin_size,      \
            log_bin, (float*)pm, (int*)idx);                                 \
    } while (0)
    switch (variant) {
%(cases)s
        default: return (int)cudaErrorInvalidValue;
    }
#undef NLL_PROBE
    return (int)cudaGetLastError();
}

#define PROBE_ZADD_DENSE(NAME, DISPATCH)                                     \
    extern "C" int NAME(const void* syms, const void* pm, int M, int Z,     \
                        int CO, const void* wt, const void* b, void* out,   \
                        int device, void* stream) {                         \
        TRY(set_device(device));                                            \
        const SymsPmSrc src{(const int*)syms, x_f(pm), M, Z};               \
        const StoreBias store{(float*)out, x_f(b), CO};                     \
        const cudaStream_t st = (cudaStream_t)stream;                       \
        if (Z % 4 == 0 && aligned16(syms) && aligned16(pm) && aligned16(wt)) \
            return (int)DISPATCH<4>(M, CO, Z, src, x_f(wt), store, st);     \
        return (int)DISPATCH<1>(M, CO, Z, src, x_f(wt), store, st);         \
    }
PROBE_ZADD_DENSE(probe_zadd_dense_junction, dispatch_junction)
PROBE_ZADD_DENSE(probe_zadd_dense_tiled, dispatch_tiled)
'''

PROBE_DIR = build.BUILD_DIR / 'probe'
PROBE_LIB = PROBE_DIR / 'libprobe.so'


def build_probe():
    """Compile trunk.cu with the probe entries appended into PROBE_LIB;
    -> ptxas's lines for the nll_head kernels (registers, spills)."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    src = PROBE_DIR / 'trunk_probe.cu'
    src.write_text((build._PKG / 'csrc' / 'trunk.cu').read_text()
                   + probe_source())
    res = subprocess.run([build.nvcc_path(), *build._FLAGS, '-Xptxas', '-v',
                          '-shared', str(src), '-o', str(PROBE_LIB)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'probe build failed:\n{res.stderr}')
    # ptxas's registers and spills of the nll_head kernels
    lines = res.stderr.splitlines()
    return [' | '.join(x.strip() for x in lines[i:i + 4])
            for i, a in enumerate(lines)
            if 'nll' in a and 'Compiling entry' in a]


def sass_counts():
    """{kernel: {'instructions': n, opcode: n, ...}}: cuobjdump's SASS of
    the main library's nll_head kernels, counted statically (a loop's body
    once), by opcode without its modifiers."""
    import re
    tool = Path(build.nvcc_path()).with_name('cuobjdump')
    out = subprocess.run([str(tool), '-sass', str(build.LIBRARY)],
                         capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        head = re.match(r'\s*Function : (\S+)', line)
        if head:
            fn = head.group(1)
            name = next((k for k in ('nll_head_kernelILi4', 'nll_head_kernel'
                                     'ILi1', 'nll_head_linear_kernel')
                         if k in fn), None)
            if name:
                counts[name] = {'instructions': 0}
            continue
        ins = re.match(r'\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?'
                       r'([A-Z][A-Z0-9]*)', line)
        if name and ins:
            c = counts[name]
            c['instructions'] += 1
            c[ins.group(1)] = c.get(ins.group(1), 0) + 1
    return counts


def probe_library():
    lib = ctypes.CDLL(str(PROBE_LIB))
    for name in ('probe_zadd_dense_junction', 'probe_zadd_dense_tiled'):
        getattr(lib, name).argtypes = build._SIGNATURES['trunk_zadd_dense']
    lib.probe_nll_head.argtypes = (
        build._SIGNATURES['trunk_nll_head'][:-2] + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
    return lib


def zadd_dense_on(entry):
    """zadd_dense through another C entry of the same signature."""
    def run(syms, pm, w, b):
        return trunk._zadd_dense_launch(entry, syms, pm, w, b)
    return run


# nll_head's probe designs: name -> (V, MODE bits, MINB, blocks (0: the
# elementwise grid, nv / threads up to 4096), threads a block). NLL_DESIGNS
# must be bitwise the linear count; NLL_FLOORS leave work out.
PREFETCH, NO_MATH, NO_SEARCH, UNROLL, CLAMP = 1, 2, 4, 8, 16
NLL_DESIGNS = {
    'nopad_v4': (4, 0, 1, 0, 256), 'nopad_v4_g528': (4, 0, 1, 528, 256),
    'nopad_v4_g264': (4, 0, 1, 264, 256),
    'nopad_v4_g132': (4, 0, 1, 132, 256),
    'nopad_v4_prefetch_g528': (4, PREFETCH, 1, 528, 256),
    'nopad_v4_prefetch_g264': (4, PREFETCH, 1, 264, 256),
    'nopad_v1': (1, 0, 1, 0, 256), 'nopad_v1_g1056': (1, 0, 1, 1056, 256),
    'nopad_v1_prefetch_g1056': (1, PREFETCH, 1, 1056, 256),
    'v4_unroll': (4, UNROLL, 1, 0, 256),
    'v4_clamp': (4, CLAMP, 1, 0, 256),
    'v4_unroll_clamp': (4, UNROLL | CLAMP, 1, 0, 256),
    'v4_t128': (4, 0, 1, 0, 128), 'v4_minb4': (4, 0, 4, 0, 256),
    'v4_minb8': (4, 0, 8, 0, 256), 'v2': (2, 0, 1, 0, 256),
    'v2_unroll_clamp': (2, UNROLL | CLAMP, 1, 0, 256),
    'v1_unroll_clamp': (1, UNROLL | CLAMP, 1, 0, 256)}
NLL_FLOORS = {'floor_no_math': (4, NO_MATH, 1, 0, 256),
              'floor_no_search': (4, NO_SEARCH, 1, 0, 256),
              'floor_copy': (4, NO_MATH | NO_SEARCH, 1, 0, 256),
              'floor_no_math_unroll_clamp': (4, NO_MATH | UNROLL | CLAMP, 1,
                                             0, 256)}
# the kernels the probe library instantiates: (V, MODE, MINB) -> case
NLL_KERNELS = {k: i for i, k in enumerate(dict.fromkeys(
    v[:3] for v in (*NLL_DESIGNS.values(), *NLL_FLOORS.values())))}


def probe_source():
    cases = '\n'.join(f'        case {i}: NLL_PROBE({v}, {mo}, {mb}); break;'
                      for (v, mo, mb), i in NLL_KERNELS.items())
    return PROBE_SOURCE.replace('%(cases)s', cases)


def nll_head_on(lib, V, mode, minb, blocks, threads):
    """nll_head through probe_nll_head's kernel (V, mode, minb) on a grid
    of `blocks` blocks of `threads`."""
    variant = NLL_KERNELS[V, mode, minb]

    def entry(*a):
        return lib.probe_nll_head(*a[:-2], variant, blocks, threads,
                                  *a[-2:])

    def run(m, r, table, bin_size):
        return trunk._nll_head_launch(entry, m, r, table, bin_size)
    return run


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
    lib, plib = build.library(), probe_library()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = dict(card=smi, build_s=info['seconds'], nll_ptxas=ptxas,
               nll_sass=sass_counts())

    g = torch.Generator(device=device).manual_seed(chip_smoke.ZDENSE_SEED)
    zadd = {'old_core': trunk.zadd_dense_oldcore,
            'junction': zadd_dense_on(plib.probe_zadd_dense_junction),
            'tiled': zadd_dense_on(plib.probe_zadd_dense_tiled),
            'main': trunk.zadd_dense}
    res['zadd_dense'] = {}
    for B in (1, 2, 4):
        args = chip_smoke.zadd_dense_args(torch, g, B, 96, 16, 48, False,
                                          device)
        want = trunk.zadd_dense_oldcore(*args)
        same = {k: chip_smoke.same_bits(torch, fn(*args), want)
                for k, fn in zadd.items()}
        res['zadd_dense'][f'M{96 * B}'] = dict(bitwise=same,
                                               ms=in_turns(zadd, args))
        if not all(same.values()):
            raise SystemExit(f'zadd_dense designs differ at B = {B}: {same}')

    m, r, _, table = chip_smoke.nll_synthetic(torch, (1, 512, 768, 3),
                                              device)
    args = (m, r, table, 1 / 127.5)
    n = m.numel()
    um, ur = (torch.empty(n + 1, device=device)[1:] for _ in range(2))
    um.copy_(m.reshape(-1))
    ur.copy_(r.reshape(-1))
    uargs = (um.reshape(m.shape), ur.reshape(m.shape), table, 1 / 127.5)
    designs = {k: nll_head_on(plib, *v) for k, v in NLL_DESIGNS.items()}
    nll = {'linear': trunk.nll_head_linear, 'main': trunk.nll_head,
           **designs}
    want = trunk.nll_head_linear(*args)
    same = {k: all(chip_smoke.same_bits(torch, a, b)
                   for a, b in zip(fn(*args), want)) for k, fn in nll.items()}
    same['main_unaligned'] = all(chip_smoke.same_bits(torch, a, b) for a, b
                                 in zip(trunk.nll_head(*uargs), want))
    times = in_turns(nll, args)
    for k, v in NLL_FLOORS.items():
        fn = nll_head_on(plib, *v)
        times[k] = [chip_smoke.graph_ms(torch, lambda: fn(*args),
                                        chip_smoke.TRUNK_INNER)]
    times['main_unaligned'] = [chip_smoke.graph_ms(
        torch, lambda: trunk.nll_head(*uargs), chip_smoke.TRUNK_INNER)]
    res['nll_head'] = dict(shape=list(m.shape), bitwise=same, ms=times)
    if not all(same.values()):
        raise SystemExit(f'nll_head designs differ: {same}')
    print(smi, flush=True)
    print(json.dumps(res), flush=True)
    if len(sys.argv) > 1:
        os.makedirs(os.path.dirname(sys.argv[1]) or '.', exist_ok=True)
        with open(sys.argv[1], 'w') as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
