"""The port's CUDA kernels on the card: the rANS kernels against their plain
versions at every lane count the codec uses, the decode kernel on its
corner cases, the encode on its corner cases against its row-sync oracle
kernel, B single launches and the plain versions, the trunk kernels
against theirs at qarv_tiny and qres_tiny shapes, dense, conv_kxk_act,
mlp_res, dense_act, prior_head, fuse_zproj and res_dense_act (the tiled
product core) bitwise against the old core (the _oldcore entry points) at
ragged shapes, dw_ln_mod and dw_ln_affine (the halo-tile stencil) bitwise
against the warp-per-pixel kernel, emb_mlp's thread-block cluster kernel
bitwise against the one-block kernel (emb_mlp_oneblock) and zadd_conv_kxk
against zadd then conv_kxk_act(act=False), nll_head's search against the
linear count (nll_head_linear) and zadd_dense against the old core, the
lossless head's two kernels against theirs bitwise, upsample_finish and
upsample_head bitwise against the chains of launches they fold, qarv_tiny,
qres_tiny and qres_tiny_lossless round trips (legacy and portable) through
them, the golden portable streams of tests/golden/, and the eval forward
of the three tiny models (stats, each block's kl, self_evaluate,
image_self_evaluate) on the card against the CPU, the eval CLI, the
native host coder on the card's machine against its numpy version, the
device coder's decode against the host coder's, qres17m's legacy
batch round trip, rd_tiny's forward on the card against the CPU on
CPU-drawn noise, and the decoder on a tiny model's own latents equal to
its reconstruction, the bf16 backbone's round trips (both trunks, B = 1
and 2), a train step of each precision, and two gloo ranks sharing the
card (the halo exchange and its gradient, the data-parallel step). Skips
without a card. On the card (which has no JAX, so the suite's
conftest cannot load):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import lvae_tpu_torch
from lvae_tpu_torch.ops import cdf, rans_decode as rd, rans_encode as re_

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _blocks(rng, sizes):
    scales = cdf.default_gaussian_scale_table()
    vals, idxs = [], []
    for sz in sizes:
        idx = rng.integers(0, 64, sz).astype(np.int32)
        v = np.round(rng.normal(0, scales[idx] * 1.5)).astype(np.int32)
        esc = rng.random(sz) < 0.02
        v[esc] = rng.integers(-500, 500, int(esc.sum()))
        vals.append(v)
        idxs.append(idx)
    return vals, idxs


@pytest.mark.parametrize('N', [16, 32, 64, 128])
def test_kernels_match_plain(card, N):
    table = cdf.build_cdf_table(cdf.default_gaussian_scale_table())
    cdfs_np, offs_np = rd.prepare_device_cdf(table)
    cdfs = torch.as_tensor(cdfs_np, device=card)
    offs = torch.as_tensor(offs_np, device=card)
    vals, idxs = _blocks(np.random.default_rng(N), [300, 7, 129, 5000])
    sym_rows, idx_rows, row_n = re_.blocks_to_rows(vals, idxs, N)
    inband, _ = re_.prepare_inband(
        torch.as_tensor(sym_rows, device=card),
        torch.as_tensor(idx_rows, device=card), offs_np, table.cdf_lengths)
    idx_t = torch.as_tensor(idx_rows, device=card)
    launches = re_.rans_encode_all.launches
    got = re_.rans_encode_all(inband, idx_t, row_n, cdfs, num_lanes=N)
    want = re_.rans_encode_all_plain(inband, idx_t, row_n, cdfs)
    assert re_.rans_encode_all.launches == launches + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    pairs, n_words, states = got
    words = re_.pairs_to_words(pairs.cpu().numpy(), int(n_words))[::-1]
    stream = torch.as_tensor(words.astype(np.int32), device=card)
    st_k = st_p = states
    p_k = p_p = torch.zeros((), dtype=torch.int32, device=card)
    for v, ix in zip(vals, idxs):
        rows = np.zeros(-(-ix.size // N) * N, np.int32)
        rows[:ix.size] = ix
        rows = torch.as_tensor(rows.reshape(-1, N), device=card)
        vk, st_k, p_k = rd.rans_decode_block(rows, st_k, p_k, stream, cdfs,
                                             offs, ix.size, num_lanes=N)
        vp, st_p, p_p = rd.rans_decode_block_plain(rows, st_p, p_p, stream,
                                                   cdfs, offs, ix.size)
        assert torch.equal(vk, vp) and torch.equal(st_k, st_p)
        assert int(p_k) == int(p_p)
    assert int(p_k) == int(n_words)


def test_qarv_tiny_roundtrip_on_card(card):
    torch.manual_seed(0)
    model = lvae_tpu_torch.get_model('qarv_tiny')
    with torch.no_grad():
        for name, p in model.net.named_parameters():
            if name.endswith('posterior.weight'):
                p.mul_(300.0)                        # make escapes occur
    model.compress_mode(num_lanes='auto')
    im = np.random.default_rng(0).uniform(0, 1, (1, 128, 192, 3))
    enc0, dec0 = re_.rans_encode_all.launches, rd.rans_decode_block.launches
    bits, recon = model.compress_check(im, lmb=1024.0)
    rec = model.decompress(bits)
    assert np.array_equal(rec, recon)
    assert re_.rans_encode_all.launches == enc0 + 1
    assert rd.rans_decode_block.launches == dec0 + 2


# ---- the portable-trunk kernels (ops/trunk.py, csrc/trunk.cu) ------------

def _trunk_cases(rng, card):
    """(name, kernel args) at qarv_tiny shapes (C = 16, E = 32, 4x4 and 1x1
    latents, the 64x64 pixel tail), ragged row counts included."""
    from lvae_tpu_torch.ops import trunk

    def f(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(
            np.float32), device=card)

    table = torch.as_tensor(cdf.default_gaussian_scale_table().astype(
        np.float32), device=card)
    syms = torch.as_tensor(rng.integers(-900, 900, (1, 16, 4)).astype(
        np.int32), device=card)
    bz = torch.cat([f(4, scale=0.1), f(4, scale=2.0)])
    return [
        ('emb_mlp', trunk.emb_mlp,
         (torch.tensor([512.0], device=card),
          torch.as_tensor(trunk.emb_freqs(32, 64), device=card),
          f(32, 32, scale=0.2), f(32), f(32, 32, scale=0.2), f(32), 64)),
        ('dw_ln_mod', trunk.dw_ln_mod,
         (f(1, 16, 16, 16), f(7, 7, 16, scale=0.2), f(16), f(32, 32),
          f(32), f(1, 32), 7)),
        ('dw_ln_mod', trunk.dw_ln_mod,
         (f(1, 4, 4, 16), f(3, 3, 16, scale=0.3), f(16), f(32, 32),
          f(32), f(1, 32), 3)),
        ('mlp_res', trunk.mlp_res,
         (f(1, 256, 16), f(16, 32, scale=0.25), f(32), f(32, 16, scale=0.2),
          f(16), f(16), f(1, 256, 16))),
        ('dense', trunk.dense, (f(1, 4096, 16), f(16, 48, scale=0.25),
                                f(48))),
        ('dense', trunk.dense, (f(1, 1, 16), f(16, 256, scale=0.25),
                                f(256))),
        ('prior_head', trunk.prior_head,
         (f(1, 16, 16), f(16, 8, scale=0.5), bz, table)),
        ('prior_head', trunk.prior_head,
         (f(1, 16, 16), f(16, 8, scale=0.5), bz, table, True)),
        ('fuse_zproj', trunk.fuse_zproj,
         (f(1, 16, 16), syms, f(1, 16, 4), f(4, 16, scale=0.01), f(16))),
        ('finish_image', trunk.finish_image, (f(1, 64, 64, 3, scale=1.5),)),
        ('upsample_finish', trunk.upsample_finish,
         (f(1, 16, 16, 16), f(16, 48, scale=0.4), f(48), 4)),
        ('upsample_head', trunk.upsample_head,
         (f(1, 16, 16, 16), f(16, 48, scale=0.25), f(48),
          f(16, 48, scale=0.25), f(48), 4)),
    ]


def test_trunk_kernels_match_plain(card):
    """Each trunk kernel against its plain version (atol 1e-5, rtol 1e-4 on
    floats; the plain products sum in another order; upsample_finish's
    float16 outputs one float16 ulp of [0.5, 1) more, as its float32 values
    round to float16 on either side of a boundary), one launch counted per
    call, and the same bits on a repeat."""
    from lvae_tpu_torch.ops import trunk
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, fn, args in _trunk_cases(np.random.default_rng(0), card):
        before = fn.launches
        got = fn(*args)
        assert fn.launches == before + 1, name
        want = trunk.PLAIN[fn](*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            if g.dtype == torch.int32:
                assert torch.equal(g, w), name
            else:
                ulp = 2.0 ** -11 if name == 'upsample_finish' else 0.0
                torch.testing.assert_close(g, w, atol=1e-5 + ulp, rtol=1e-4)
        again = fn(*args)
        again = again if isinstance(again, tuple) else (again,)
        assert all(torch.equal(a, g) for a, g in zip(again, got)), name


def test_portable_qarv_tiny_roundtrip_on_card(card, tmp_path):
    from lvae_tpu_torch.ops import trunk
    torch.manual_seed(0)
    model = lvae_tpu_torch.get_model('qarv_tiny')
    with torch.no_grad():
        for name, p in model.net.named_parameters():
            if name.endswith('posterior.weight'):
                p.mul_(300.0)                        # make escapes occur
    model.compress_mode(num_lanes='auto', portable=True)
    im = np.random.default_rng(0).uniform(0, 1, (1, 128, 192, 3))
    counts = {k.__name__: k.launches for k in trunk.KERNELS}
    bits, recon = model.compress_check(im, lmb=1024.0)
    rec = model.decompress(bits)
    assert np.array_equal(rec, recon)
    # the trunk (emb, 2 latent blocks of 2 ConvNeXt blocks, 1 upsample) and
    # the tail (2 ConvNeXt blocks, 1 upsample, the last upsample with the
    # finish), once in compress_check and once in decompress
    per_image = {'emb_mlp': 1, 'dw_ln_mod': 6, 'mlp_res': 6, 'dense': 2,
                 'prior_head': 2, 'fuse_zproj': 2, 'upsample_finish': 1}
    for k in trunk.KERNELS:                  # the QRes kernels: none
        assert (k.launches - counts[k.__name__]
                == 2 * per_image.get(k.__name__, 0))


# ---- the multi-image rANS kernels and batch serving ------------------------

@pytest.mark.parametrize('N', [16, 128])
def test_multi_kernels_match_plain_and_single_launches(card, N):
    """Each multi kernel at B = 2 against its plain version and against two
    single-kernel launches, one launch counted per call."""
    B = 2
    table = cdf.build_cdf_table(cdf.default_gaussian_scale_table())
    cdfs_np, offs_np = rd.prepare_device_cdf(table)
    cdfs = torch.as_tensor(cdfs_np, device=card)
    offs = torch.as_tensor(offs_np, device=card)
    sizes = [300, 7, 129, 5000]
    rows = [re_.blocks_to_rows(*_blocks(np.random.default_rng(N + b), sizes),
                               N) for b in range(B)]
    row_n = torch.as_tensor(rows[0][2], device=card)
    idx = torch.as_tensor(np.stack([r[1] for r in rows]), device=card)
    inband, _ = re_.prepare_inband(
        torch.as_tensor(np.stack([r[0] for r in rows]), device=card), idx,
        offs_np, table.cdf_lengths)
    launches = re_.rans_encode_all_multi.launches
    got = re_.rans_encode_all_multi(inband, idx, row_n, cdfs, num_lanes=N)
    assert re_.rans_encode_all_multi.launches == launches + 1
    want = re_.rans_encode_all_multi_plain(inband, idx, row_n, cdfs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    pairs, n_words, states = got
    streams = np.zeros((B, int(n_words.max())), np.int32)
    for b in range(B):
        p1, n1, s1 = re_.rans_encode_all(inband[b], idx[b], row_n, cdfs,
                                         num_lanes=N)
        assert torch.equal(pairs[b], p1) and torch.equal(n_words[b], n1)
        assert torch.equal(states[b], s1[0])
        words = re_.pairs_to_words(p1.cpu().numpy(), int(n1))[::-1]
        streams[b, :words.size] = words
    streams = torch.as_tensor(streams, device=card)
    st_k = st_p = states
    p_k = p_p = torch.zeros(B, dtype=torch.int32, device=card)
    st_1 = [states[b:b + 1] for b in range(B)]
    p_1 = [torch.zeros((), dtype=torch.int32, device=card)] * B
    r0 = 0
    for size in sizes:
        Tb = -(-size // N)
        blk = idx[:, r0:r0 + Tb].contiguous()
        launches = rd.rans_decode_block_multi.launches
        vk, st_k, p_k = rd.rans_decode_block_multi(
            blk, st_k, p_k, streams, cdfs, offs, size, num_lanes=N)
        assert rd.rans_decode_block_multi.launches == launches + 1
        vp, st_p, p_p = rd.rans_decode_block_multi_plain(
            blk, st_p, p_p, streams, cdfs, offs, size)
        assert torch.equal(vk, vp) and torch.equal(st_k, st_p)
        assert torch.equal(p_k, p_p)
        for b in range(B):
            v1, st_1[b], p_1[b] = rd.rans_decode_block(
                blk[b], st_1[b], p_1[b], streams[b], cdfs, offs, size,
                num_lanes=N)
            assert torch.equal(vk[b], v1) and torch.equal(st_k[b], st_1[b][0])
        r0 += Tb
    assert p_k.tolist() == n_words.tolist()


def test_portable_qarv_tiny_batch_roundtrip_on_card(card):
    """compress_batch / decompress_batch on the card: bit-exact against
    encode_check_batch and across batch sizes, one multi-image launch per
    encode and one per latent block on decode, no single-image rANS
    launch."""
    torch.manual_seed(0)
    model = lvae_tpu_torch.get_model('qarv_tiny')
    with torch.no_grad():
        for name, p in model.net.named_parameters():
            if name.endswith('posterior.weight'):
                p.mul_(300.0)                        # make escapes occur
    model.compress_mode(num_lanes='auto', portable=True)
    ims = np.random.default_rng(0).uniform(0, 1, (3, 128, 192, 3))
    lmbs = [64.0, 512.0, 2048.0]
    kernels = (re_.rans_encode_all, rd.rans_decode_block,
               re_.rans_encode_all_multi, rd.rans_decode_block_multi)
    before = [k.launches for k in kernels]
    bodies = model.compress_batch(ims, lmb=lmbs)
    dec = model.decompress_batch(bodies)
    assert [k.launches - b for k, b in zip(kernels, before)] == [0, 0, 1, 2]
    lmb_t = torch.tensor(lmbs, device=card)
    ims_t = torch.as_tensor(ims, dtype=torch.float32, device=card)
    bodies2, recon = model._fused.encode_check_batch(
        ims_t.permute(0, 3, 1, 2).contiguous(), lmb_t)
    assert [b[10:] for b in bodies] == bodies2
    assert np.array_equal(dec, recon)
    for b, body in enumerate(bodies):
        assert np.array_equal(model.decompress(body)[0], dec[b])


def test_batch_spans_and_counters_on_card(card):
    """With the recorder on, the encode's finish waits for each chunk's
    payload copy inside enc.pull_wait, and the launch counters grow by
    the wrappers' launches: one multi-image rANS launch a latent block on
    decode."""
    from lvae_tpu_torch.utils import trace
    torch.manual_seed(0)
    model = lvae_tpu_torch.get_model('qarv_tiny')
    model.compress_mode(num_lanes='auto', portable=True, max_program_batch=2)
    ims = torch.rand(3, 128, 192, 3, device=card)
    lmbs = [64.0, 512.0, 2048.0]
    model.decompress_batch(model.compress_batch(ims, lmb=lmbs))     # warm
    trace.start()
    try:
        bodies = model.compress_batch_finish(
            model.compress_batch_async(ims, lmb=lmbs))
        before = trace.counters()
        model.decompress_batch_to_device(bodies)
        after = trace.counters()
    finally:
        spans = trace.stop()
    fin, = [i for i, s in enumerate(spans) if s[0] == 'enc.finish']
    assert [s[0] for s in spans if s[3] == fin] == ['enc.pull_wait'] * 2
    delta = {k: after[k] - before[k] for k in after}
    rans = sum(1 for s in spans if s[0] == 'dec.rans')
    assert rans == 4 and delta['rans_decode_block_multi'] == rans
    assert delta['rans_encode_all_multi'] == 0
    assert sum(delta.values()) > rans


# ---- the QRes-VAE trunk kernels ---------------------------------------------

def _qres_cases(rng, card):
    """(name, kernel args) at qres_tiny shapes (C = 16, hidden 4, Z = 4; 1x1,
    4x4 and 16x16 latents) and at one qres34m shape each, ragged row counts
    and the 3x3 conv's edges included."""
    from lvae_tpu_torch.ops import trunk

    def f(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(
            np.float32), device=card)

    syms = torch.as_tensor(rng.integers(-900, 900, (1, 63, 4)).astype(
        np.int32), device=card)
    return [
        ('zadd_conv_kxk', trunk.zadd_conv_kxk,
         (syms.reshape(1, 9, 7, 4), f(1, 9, 7, 4), f(3, 3, 4, 8, scale=0.01),
          f(8))),
        ('dw_ln_affine', trunk.dw_ln_affine,
         (f(1, 16, 16, 16), f(7, 7, 16, scale=0.2), f(16), f(16), f(16), 7)),
        ('dw_ln_affine', trunk.dw_ln_affine,
         (f(2, 8, 12, 384), f(1, 1, 384), f(384), f(384), f(384), 1)),
        ('dense_act', trunk.dense_act,
         (f(1, 16, 16), f(16, 4, scale=0.25), f(4))),
        ('dense_act', trunk.dense_act,
         (f(1, 96, 384), f(384, 96, scale=0.05), f(96), False)),
        ('conv_kxk_act', trunk.conv_kxk_act,
         (f(1, 9, 7, 4), f(3, 3, 4, 4, scale=0.3), f(4))),
        ('conv_kxk_act', trunk.conv_kxk_act,
         (f(2, 16, 24, 96), f(3, 3, 96, 96, scale=0.03), f(96))),
        ('conv_kxk_act', trunk.conv_kxk_act,
         (f(1, 9, 7, 4), f(3, 3, 4, 2, scale=0.3), f(2), False)),
        ('zadd_dense', trunk.zadd_dense,
         (syms, f(1, 63, 4), f(4, 48, scale=0.01), f(48))),
        ('zadd', trunk.zadd, (syms, f(1, 63, 4))),
        ('res_dense_act', trunk.res_dense_act,
         (f(1, 63, 16), f(1, 63, 2), f(2, 16, scale=0.5), f(16))),
        ('res_dense_act', trunk.res_dense_act,
         (f(1, 384, 384), f(1, 384, 48), f(48, 384, scale=0.1), f(384))),
    ]


def test_qres_trunk_kernels_match_plain(card):
    """Each QRes trunk kernel against its plain version (atol 1e-5, rtol
    1e-4), one launch counted per call, the same bits on a repeat, and the
    first image of a batch of two getting the bits it gets alone."""
    from lvae_tpu_torch.ops import trunk
    per_image = {'dw_ln_affine': (0,), 'dense_act': (0,),
                 'conv_kxk_act': (0,), 'zadd_dense': (0, 1), 'zadd': (0, 1),
                 'zadd_conv_kxk': (0, 1), 'res_dense_act': (0, 1)}
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, fn, args in _qres_cases(np.random.default_rng(1), card):
        before = fn.launches
        got = fn(*args)
        assert fn.launches == before + 1, name
        want = trunk.PLAIN[fn](*args)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
        assert torch.equal(fn(*args), got), name
        two = [torch.cat([a, a.flip(-1)]) if i in per_image[name] else a
               for i, a in enumerate(args)]
        assert torch.equal(fn(*two)[:got.shape[0]], got), name


def test_portable_qres_tiny_roundtrip_on_card(card):
    """qres_tiny at 128x192 on the portable trunk: bit-exact, and the QRes
    kernels launched as the block list says (3 latent blocks: 1x1, 3x3 and
    7x7; 2 upsamples in the trunk, 1 in the tail; z_proj_0 of the 3x3 and
    7x7 blocks as zadd_conv_kxk, zadd never; the tail's upsample with the
    finish as upsample_finish, finish_image never) once in compress_check
    and once in decompress."""
    from lvae_tpu_torch.ops import trunk
    torch.manual_seed(0)
    model = lvae_tpu_torch.get_model('qres_tiny')
    with torch.no_grad():
        for name, p in model.net.named_parameters():
            if name.endswith('posterior.c4.weight'):
                p.mul_(300.0)                        # make escapes occur
    model.compress_mode(portable=True, esc_cap=1 << 16)
    im = np.random.default_rng(0).uniform(0, 1, (1, 128, 192, 3))
    counts = {k.__name__: k.launches for k in trunk.KERNELS}
    obj, recon = model.compress_check(im)
    assert np.array_equal(model.decompress(obj), recon)
    per_image = {'dw_ln_affine': 6, 'mlp_res': 6, 'dense_act': 5,
                 'conv_kxk_act': 4, 'prior_head': 3, 'zadd': 0,
                 'zadd_conv_kxk': 2, 'zadd_dense': 1, 'res_dense_act': 3,
                 'dense': 2, 'upsample_finish': 1, 'upsample_head': 0,
                 'finish_image': 0, 'emb_mlp': 0, 'dw_ln_mod': 0,
                 'fuse_zproj': 0, 'nll_head': 0, 'nll_recon': 0}
    for k in trunk.KERNELS:
        assert k.launches - counts[k.__name__] == 2 * per_image[k.__name__]


# ---- the tiled product core (dense, conv_kxk_act, dense_act, prior_head) ----

# ragged rows M (a (B, H, W) grid for the conv), widths N, input channels Ci
# at kernel sizes K: the depths K*K*Ci include every remainder mod 16 the
# trunk meets, and Ci 10 and 14 take the 4-byte copies
CORE_M = {1: (1, 1, 1), 95: (1, 5, 19), 385: (1, 11, 35)}
CORE_CASES = [(M, N, Ci, K) for M in CORE_M for N in (24, 48, 96, 2048)
              for Ci in (8, 10, 14, 48, 96) for K in (1, 3, 5)]


def _core_oracle(args):
    """The same function through dense_act_oldcore on the old product core:
    each output's sum is the same fmaf chain, so the tiled core's bits must
    equal it."""
    from lvae_tpu_torch.ops import trunk
    if len(args) == 3:
        return trunk.dense_act_oldcore(*args, False)
    x, wk, b, act = args
    B, H, W, Ci = x.shape
    K, Co = wk.shape[0], wk.shape[-1]
    return trunk.dense_act_oldcore(trunk.im2col_tapmajor(x, K),
                                   wk.reshape(K * K * Ci, Co), b,
                                   act).reshape(B, H, W, Co)


def _f(rng, card, *shape, scale=1.0):
    return torch.as_tensor((rng.normal(size=shape) * scale).astype(
        np.float32), device=card)


def test_tiled_core_dense_equals_old_core(card):
    """dense on the tiled core is bitwise dense_act_oldcore(act=False) at
    every synthetic shape, also from rows 4 bytes off 16."""
    from lvae_tpu_torch.ops import trunk
    rng = np.random.default_rng(7)
    for M, N, Ci, K in CORE_CASES:
        C = K * K * Ci
        w, b = _f(rng, card, C, N, scale=C ** -0.5), _f(rng, card, N)
        x = _f(rng, card, 1, M, C)
        unaligned = _f(rng, card, M * C + 1)[1:].reshape(1, M, C)
        for xd in (x, unaligned):
            got = trunk.dense(xd, w, b)
            assert torch.equal(got, _core_oracle((xd, w, b))), \
                (M, N, C, xd.data_ptr() % 16)


def test_tiled_core_conv_equals_old_core(card):
    """conv_kxk_act on the tiled core (and its GELU pre-pass) is bitwise
    dense_act_oldcore on im2col_tapmajor's columns at every synthetic
    shape, act on and off."""
    from lvae_tpu_torch.ops import trunk
    rng = np.random.default_rng(8)
    for M, N, Ci, K in CORE_CASES:
        C = K * K * Ci
        x = _f(rng, card, *CORE_M[M], Ci)
        wk, b = _f(rng, card, K, K, Ci, N, scale=C ** -0.5), _f(rng, card, N)
        for act in (True, False):
            args = (x, wk, b, act)
            got = trunk.conv_kxk_act(*args)
            assert torch.equal(got, _core_oracle(args)), (M, N, Ci, K, act)


# per kernel: shapes of each tile family (dense: M, C, N; conv_kxk_act: H,
# W, Ci, Co, act; dense_act: M, C, N, act; prior_head: M, C, Z, act;
# fuse_zproj: M, Z, C; res_dense_act: M, Ci, C), the main path's among them
_FAMILY_SHAPES = {
    'dense': [(96, 512, 2048), (384, 512, 1536), (1536, 384, 1024),
              (6144, 256, 512), (24576, 128, 48), (95, 90, 24)],
    'conv_kxk_act': [(16, 24, 96, 96, True), (64, 96, 96, 96, True),
                     (128, 192, 48, 48, True), (16, 24, 14, 48, False),
                     (128, 192, 8, 24, False), (5, 19, 10, 24, True)],
    'dense_act': [(96, 96, 96, True), (96, 384, 96, True),
                  (1536, 384, 96, True), (6144, 384, 96, True),
                  (24576, 192, 48, True), (95, 10, 24, False)],
    'prior_head': [(96, 512, 64, False), (1536, 384, 192, False),
                   (6144, 256, 16, False), (96, 96, 32, True),
                   (6144, 96, 20, True), (24576, 48, 16, True),
                   (95, 10, 1, False)],
    'fuse_zproj': [(96, 32, 512), (384, 32, 512), (1536, 96, 384),
                   (6144, 8, 256), (95, 10, 24)],
    'res_dense_act': [(96, 48, 384), (1536, 48, 384), (6144, 48, 384),
                      (24576, 24, 192), (95, 14, 24)]}


@pytest.mark.parametrize('name', sorted(_FAMILY_SHAPES))
def test_tiled_core_batch_launches_and_repeat(card, name):
    """One launch counted per call, the same bits on a repeat, the first
    image of a batch of two its bits alone (the tile shape may follow the
    row count; no output's chain does), at shapes of each tile family;
    dense_act, prior_head, fuse_zproj and res_dense_act also bitwise their
    _oldcore oracles."""
    import chip_smoke
    from lvae_tpu_torch.ops import trunk
    rng = np.random.default_rng(9)
    fn = getattr(trunk, name)
    table = torch.as_tensor(chip_smoke.prior_tables(np)['codec'],
                            device=card)
    for shape in _FAMILY_SHAPES[name]:
        if name == 'conv_kxk_act':
            H, W, Ci, Co, act = shape
            args = [_f(rng, card, 1, H, W, Ci),
                    _f(rng, card, 3, 3, Ci, Co, scale=(9 * Ci) ** -0.5),
                    _f(rng, card, Co), act]
        elif name in ('fuse_zproj', 'res_dense_act'):
            M, K, C = shape
            args = [_f(rng, card, 1, M, C), _f(rng, card, 1, M, K),
                    _f(rng, card, K, C, scale=K ** -0.5), _f(rng, card, C)]
            if name == 'fuse_zproj':
                syms = torch.as_tensor(rng.integers(-40, 41, (1, M, K)),
                                       dtype=torch.int32, device=card)
                args[1:2] = [syms, _f(rng, card, 1, M, K)]
        else:
            M, C, N = shape[:3]
            N = 2 * N if name == 'prior_head' else N
            args = [_f(rng, card, 1, M, C),
                    _f(rng, card, C, N, scale=C ** -0.5), _f(rng, card, N)]
            args += ([table, shape[3]] if name == 'prior_head'
                     else list(shape[3:]))
        before = fn.launches
        got = fn(*args)
        assert fn.launches == before + 1, shape
        again = fn(*args)
        got_t, again_t = ((got, again) if isinstance(got, tuple)
                          else ((got,), (again,)))
        assert all(torch.equal(a, g) for a, g in zip(again_t, got_t)), shape
        torch.testing.assert_close(got_t[0], trunk.PLAIN[fn](*args)[0]
                                   if name == 'prior_head'
                                   else trunk.PLAIN[fn](*args),
                                   atol=1e-5, rtol=1e-4)
        if name in ('dense_act', 'prior_head', 'fuse_zproj',
                    'res_dense_act'):
            assert chip_smoke.core_bitwise(torch, name, args, got), shape
        two = list(args)
        for i in chip_smoke.PER_IMAGE_ARGS[name]:
            two[i] = torch.cat([args[i], args[i].flip(-1)])
        two_t = fn(*two)
        two_t = two_t if isinstance(two_t, tuple) else (two_t,)
        assert all(torch.equal(t[:1], g) for t, g in zip(two_t, got_t)), \
            shape


def test_dense_act_and_prior_head_equal_old_core_synthetic(card):
    """dense_act (its GELU pre-pass and dense_act_staged's GELU on the
    staged tile) and prior_head on the tiled core are bitwise their
    _oldcore oracles at chip_smoke's synthetic shapes (rows 1 to 6144,
    depths 10 to 512, act on and off, unaligned rows, non-finite rows) and
    scale tables (the codecs', ties, one entry, 65, shuffled, and one past
    the shared-memory stage); only the main wrappers count launches, one a
    call."""
    import chip_smoke
    from lvae_tpu_torch.ops import trunk
    counts = trunk.dense_act.launches, trunk.prior_head.launches
    cases, bad, calls = chip_smoke.check_prior_dense_act_synthetic(torch,
                                                                   card)
    assert cases > 1000 and not bad, bad[:5]
    per_kernel = (trunk.dense_act.launches - counts[0],
                  trunk.prior_head.launches - counts[1])
    assert sum(per_kernel) == calls, per_kernel


def test_fuse_zproj_and_res_dense_act_equal_old_core_synthetic(card):
    """fuse_zproj and res_dense_act (both GELU designs) on the tiled core are
    bitwise their _oldcore oracles on a smaller copy of chip_smoke's
    synthetic check (rows 1 to 6144, depths 1 to 96 with the 4-byte
    copies, widths 24 to 512, unaligned inputs, symbols up to 2^24 - 1,
    NaN/inf rows, -0 in the feature); only the main wrappers count
    launches, one a call."""
    import chip_smoke
    from lvae_tpu_torch.ops import trunk
    counts = trunk.fuse_zproj.launches, trunk.res_dense_act.launches
    cases, bad, calls = chip_smoke.check_junction_synthetic(
        torch, card, Ms=(1, 95, 385, 6144), Ks=(1, 8, 10, 14, 24, 48, 96),
        Ns=(24, 192, 512))
    assert cases == 3 * 4 * 7 * 3 * 2 and not bad, bad[:5]
    per_kernel = (trunk.fuse_zproj.launches - counts[0],
                  trunk.res_dense_act.launches - counts[1])
    assert per_kernel == (calls // 2, calls // 2), per_kernel


def test_mlp_res_equals_old_core(card):
    """mlp_res on the tiled core is bitwise its oracle on the old core
    (chip_smoke.core_oracle: fc1, then fc2 with the GELU on its input, then
    the residual) at ragged shapes, the narrow qarv shapes, one output
    width unlike the input's and one hidden width that is no multiple of 4
    (fc2 from the 4-byte copies); one launch counted a call; the first
    image of a batch of two its bits alone."""
    import chip_smoke
    from lvae_tpu_torch.ops import trunk
    rng = np.random.default_rng(10)
    for M, C, HID, CO in [(1, 128, 192, 128), (95, 192, 384, 192),
                          (385, 384, 1536, 384), (96, 512, 2048, 512),
                          (384, 512, 1536, 512), (95, 384, 1536, 192),
                          (95, 128, 190, 128)]:
        args = [_f(rng, card, 1, M, C), _f(rng, card, C, HID, scale=C ** -0.5),
                _f(rng, card, HID), _f(rng, card, HID, CO, scale=HID ** -0.5),
                _f(rng, card, CO), _f(rng, card, CO, scale=0.1),
                _f(rng, card, 1, M, CO)]
        before = trunk.mlp_res.launches
        got = trunk.mlp_res(*args)
        assert trunk.mlp_res.launches == before + 1
        assert torch.equal(got, chip_smoke.core_oracle(torch, 'mlp_res',
                                                       args)), (M, C, HID, CO)
        two = list(args)
        for i in (0, 6):
            two[i] = torch.cat([args[i], args[i].flip(-1)])
        assert torch.equal(trunk.mlp_res(*two)[:1], got), (M, C, HID, CO)


# ---- the depthwise stencil pair on the halo-tile kernel --------------------

def _dw_args(rng, card, name, B, H, W, C, K, unaligned=False):
    x = (_f(rng, card, B * H * W * C + 1)[1:].reshape(B, H, W, C)
         if unaligned else _f(rng, card, B, H, W, C))
    dwk, dwb = _f(rng, card, K, K, C, scale=0.3), _f(rng, card, C, scale=0.1)
    if name == 'dw_ln_mod':
        return [x, dwk, dwb, _f(rng, card, 64, 2 * C, scale=0.2),
                _f(rng, card, 2 * C, scale=0.1), _f(rng, card, B, 64), K]
    return [x, dwk, dwb, _f(rng, card, C, scale=0.5) + 1,
            _f(rng, card, C, scale=0.1), K]


@pytest.mark.parametrize('name', ['dw_ln_mod', 'dw_ln_affine'])
def test_dw_tile_equals_warp_kernel_ragged(card, name):
    """dw_ln_mod and dw_ln_affine on the halo-tile kernel are bitwise the
    warp-per-pixel kernel (the _warp entry points) at ragged shapes: H and
    W of 1, 3, 5, 13 and 130 (below K too), C of 8, 40, 128, 200, 384 and
    512, K of 1, 3, 5, 7, 9 and 31 (the run-time-K instantiation, 31 in
    bands of tap rows), and at 13 x 130 a batch of two from an input 4
    bytes off 16."""
    import chip_smoke
    from lvae_tpu_torch.ops import trunk
    rng = np.random.default_rng(12)
    fn, oracle = getattr(trunk, name), getattr(trunk, name + '_warp')
    for H, W in [(h, w) for h in chip_smoke.DW_HW for w in chip_smoke.DW_HW]:
        for C in chip_smoke.DW_C:
            for K in chip_smoke.DW_K:
                cases = [(1, False)] + ([(2, True)] if (H, W) == (13, 130)
                                        else [])
                for B, unaligned in cases:
                    args = _dw_args(rng, card, name, B, H, W, C, K,
                                    unaligned)
                    assert torch.equal(fn(*args), oracle(*args)), \
                        (B, H, W, C, K, unaligned)


@pytest.mark.parametrize('name,C', [('dw_ln_affine', 192),
                                    ('dw_ln_mod', 128)])
def test_dw_tile_quarter_grid(card, name, C):
    """At the 1/4 grid of a 512x768 photo (128 x 192, K = 7: qres34m's and
    qarv_base's widths) the halo-tile kernel is bitwise the warp-per-pixel
    kernel, within tolerance of the plain version, counts one launch a call
    (the oracle none), repeats its bits, and gives the first image of a
    batch of two the bits it gets alone."""
    from lvae_tpu_torch.ops import trunk
    rng = np.random.default_rng(13)
    fn, oracle = getattr(trunk, name), getattr(trunk, name + '_warp')
    args = _dw_args(rng, card, name, 1, 128, 192, C, 7)
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before + 1
    assert torch.equal(got, oracle(*args))
    assert fn.launches == before + 1
    assert torch.equal(fn(*args), got)
    torch.testing.assert_close(got, trunk.PLAIN[fn](*args), atol=1e-5,
                               rtol=1e-4)
    two = list(args)
    per_image = (0, 5) if name == 'dw_ln_mod' else (0,)
    for i in per_image:
        two[i] = torch.cat([args[i], args[i].flip(-1)])
    assert torch.equal(fn(*two)[:1], got)


# ---- emb_mlp on its cluster, zadd folded into z_proj_0 ----------------------

def _same_bits(a, b):
    import chip_smoke
    return chip_smoke.same_bits(torch, a, b)


@pytest.mark.parametrize('E', [32, 256, 2048])
def test_emb_mlp_cluster_equals_oneblock(card, E):
    """emb_mlp's cluster kernel is bitwise the one-block kernel at qarv_tiny's
    and qarv_base's widths and at 2048 (whose weight rows do not fit in
    shared memory), B = 1, 2, 6, 7 and 200 (rows in chunks at 256 and
    2048), clusters of 16 CTAs (emb_mlp) and 8 (emb_mlp_cluster8), lambdas
    over [1, 8192]; one launch counted a call of emb_mlp, none for the
    8-CTA yardstick or the oracle; within tolerance of the plain version;
    the first row of a batch gets the bits it gets alone."""
    import chip_smoke
    from lvae_tpu_torch.ops import trunk
    rng = np.random.default_rng(E)
    w = (torch.as_tensor(trunk.emb_freqs(E, 64), device=card),
         _f(rng, card, E, E, scale=E ** -0.5), _f(rng, card, E, scale=0.1),
         _f(rng, card, E, E, scale=E ** -0.5), _f(rng, card, E, scale=0.1),
         64)
    for B in chip_smoke.EMB_B:
        lmb = torch.tensor([chip_smoke.EMB_LAMBDAS[i % 7] for i in range(B)],
                           device=card)
        want = trunk.emb_mlp_oneblock(lmb, *w)
        for cluster, fn in chip_smoke.EMB_CLUSTERS.items():
            before = trunk.emb_mlp.launches
            got = getattr(trunk, fn)(lmb, *w)
            assert trunk.emb_mlp.launches == before + (fn == 'emb_mlp')
            assert all(_same_bits(g, o) for g, o in zip(got, want)), \
                (B, cluster)
        for g, p in zip(got, trunk.emb_mlp_plain(lmb, *w)):
            torch.testing.assert_close(g, p, atol=1e-5, rtol=1e-4)
        alone = trunk.emb_mlp(lmb[:1], *w)
        assert all(_same_bits(g[:1], a) for g, a in zip(got, alone))


def test_zadd_conv_kxk_equals_zadd_then_conv(card):
    """zadd_conv_kxk is bitwise zadd then conv_kxk_act(act=False) at
    chip_smoke's cases: qres34m's four z_proj_0 shapes at B = 1, 2 and 6,
    and H, W of 1 to 13 with Z of 1 to 17 (symbols up to 2^24 - 1, -0, NaN
    and +-inf in pm, unaligned inputs at Z % 4 == 0); one launch counted a
    call (zadd's and the conv's count their own); the first image of a
    batch of two gets the bits it gets alone."""
    import chip_smoke
    from lvae_tpu_torch.ops import trunk
    g = torch.Generator(device=card).manual_seed(chip_smoke.ZCONV_SEED)
    cases = chip_smoke.zconv_cases()
    before = trunk.zadd_conv_kxk.launches
    bad = [c for c in cases if not chip_smoke.oracle_bitwise(
        torch, 'zadd_conv_kxk', chip_smoke.zconv_args(torch, g, *c, card))]
    assert len(cases) > 800 and not bad, bad[:5]
    assert trunk.zadd_conv_kxk.launches == before + len(cases)
    # its check against the plain version, to a tolerance, is the
    # zadd_conv_kxk case of test_qres_trunk_kernels_match_plain
    args = chip_smoke.zconv_args(torch, g, 2, 32, 48, 12, 48, False, card)
    got = trunk.zadd_conv_kxk(*args)
    one = trunk.zadd_conv_kxk(args[0][:1], args[1][:1], *args[2:])
    assert _same_bits(got[:1], one)


def test_zadd_conv_kxk_and_plain_within_rounding_of_float64(card):
    """zadd_conv_kxk and its plain version sum z_proj_0's taps in different
    orders, so they differ (by 0.78 near symbols of 2^24, by 1.3e-5 where
    sums of small symbols cancel): each lies within the float32 rounding
    bound of any summation order of the float64 value
    (chip_smoke.f64_witness) at every chip_smoke case, NaN and infinities
    where the float64 value has them."""
    import chip_smoke
    from lvae_tpu_torch.ops import trunk
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=card).manual_seed(chip_smoke.ZCONV_SEED)
    worst = 0.0
    for c in chip_smoke.zconv_cases():
        args = chip_smoke.zconv_args(torch, g, *c, card)
        shares = chip_smoke.f64_witness(torch, args, (
            trunk.zadd_conv_kxk(*args), trunk.zadd_conv_kxk_plain(*args)))
        worst = max([worst] + [r[0] for r in shares])
        assert all(r[0] <= 1.0 for r in shares), (c, shares)
    assert worst > 0.0          # the witness saw rounding, not nothing


# ---- nll_head's search, zadd_dense on the tiled core ------------------------

@pytest.mark.parametrize('S', [1, 2, 3, 64, 127, 128, 129, 1000, 1024])
def test_nll_head_search_equals_linear_and_plain(card, S):
    """nll_head's search is bitwise nll_head_linear (the count over all S
    entries) and nll_head_plain, pm and indexes, on chip_smoke's cases at
    table size S: exp-linspace tables, tables with a scale at, one ulp
    below and one ulp above every entry, and tied ones; raw scales +inf, NaN,
    overflowing and -inf, means +-inf; the four-element path and the
    one-element path (n % 4 != 0, and 4 bytes off 16). One launch counted
    a call of nll_head, none of the oracle."""
    import chip_smoke
    from lvae_tpu_torch.ops import trunk
    assert S in chip_smoke.NLL_S
    for label, args in chip_smoke.nll_search_cases(torch, S, card):
        before = trunk.nll_head.launches
        got = trunk.nll_head(*args)
        assert trunk.nll_head.launches == before + 1
        assert chip_smoke.nll_head_bitwise(torch, args, got), label
        assert trunk.nll_head.launches == before + 1
        # NaN's scale is the first entry (index 0), +inf's past the last
        assert int(got[1].min()) == 0 and int(got[1].max()) == S - 1, label


def test_zadd_dense_equals_old_core(card):
    """zadd_dense on the tiled core is bitwise zadd_dense_oldcore at
    chip_smoke's cases (rows 1 to 576, Z 1, 3, 16 and 17, widths 1, 48 and
    50, aligned and 4 bytes off 16; symbols up to 2^24 - 1, -0, NaN and
    +-inf in pm); one launch counted a call, none for the oracle; at the
    main path's shape the first image of a batch of two gets the bits it
    gets alone, also on the old core."""
    import chip_smoke
    from lvae_tpu_torch.ops import trunk
    g = torch.Generator(device=card).manual_seed(chip_smoke.ZDENSE_SEED)
    cases = chip_smoke.zadd_dense_cases()
    before = trunk.zadd_dense.launches
    bad = []
    for c in cases:
        args = chip_smoke.zadd_dense_args(torch, g, *c, card)
        if not _same_bits(trunk.zadd_dense(*args),
                          trunk.zadd_dense_oldcore(*args)):
            bad.append(c)
    assert not bad, bad[:5]
    assert trunk.zadd_dense.launches == before + len(cases)
    args = chip_smoke.zadd_dense_args(torch, g, 2, 96, 16, 48, False, card)
    got = trunk.zadd_dense(*args)
    assert _same_bits(got, trunk.zadd_dense_oldcore(*args))
    one = (args[0][:1], args[1][:1], *args[2:])
    assert _same_bits(got[:1], trunk.zadd_dense(*one))
    assert _same_bits(got[:1], trunk.zadd_dense_oldcore(*one))


# ---- the rANS decode kernel at its corners ---------------------------------

@pytest.mark.parametrize('table', ['latent', 'head', 'narrow', 'wide'])
@pytest.mark.parametrize('N', [1, 16, 48, 100, 128])
def test_decode_corner_cases_match_plain(card, N, table):
    """The decode kernel, single and multi-image, on chip_smoke's
    rans_corner_cases (every lane renormalising, none, a stream cut short,
    nsym ending inside a row, the stream ring wrapped), byte for byte
    against its plain versions and two single launches, with each table of
    chip_smoke.corner_scale_tables: the latent table (S = 64), the
    lossless head's (S = 128), 40 rows shorter than the kernel's 256
    entries, and 16 rows padded to 1024 (the search's extra round)."""
    import chip_smoke
    scales = chip_smoke.corner_scale_tables()[table]
    cdfs_np, offs_np = rd.prepare_device_cdf(cdf.build_cdf_table(scales))
    cdfs = torch.as_tensor(cdfs_np, device=card)
    offs = torch.as_tensor(offs_np, device=card)
    for name, case in chip_smoke.rans_corner_cases(np, cdfs_np, offs_np, N):
        single, multi, _ = chip_smoke.decode_corner_case(torch, case, cdfs,
                                                         offs, N)
        assert single and multi, name


# ---- the rANS encode against its row-sync oracle ---------------------------

@pytest.mark.parametrize('table', ['latent', 'head'])
@pytest.mark.parametrize('N', [1, 16, 31, 32, 33, 48, 64, 100, 128])
def test_encode_corner_cases_match_rowsync_and_plain(card, N, table):
    """The four-phase encode on chip_smoke's rans_encode_corner_cases
    (every lane renormalising, none, empty and tail rows, one row,
    out-of-range indexes and symbols, w_cap inside a row, 1 and T * N,
    60,007 rows at N = 1), byte for byte against the row-sync kernel, B
    single launches (B = 1, 2, 3, 6) and the plain versions."""
    import chip_smoke
    scales = chip_smoke.corner_scale_tables()[table]
    cdfs_np, _ = rd.prepare_device_cdf(cdf.build_cdf_table(scales))
    cdfs = torch.as_tensor(cdfs_np, device=card)
    for name, case in chip_smoke.rans_encode_corner_cases(np, cdfs_np, N):
        assert all(chip_smoke.encode_corner_case(torch, case, cdfs, N)), name


@pytest.mark.parametrize('N', [1, 33, 128])
def test_encode_any_table_matches_rowsync(card, N):
    """On tables of random int32 entries (frequencies 0 and past 16 bits,
    negative starts), with indexes and symbols past both ends and random
    row lengths, the encode writes the row-sync kernel's bytes: the same
    u32 arithmetic, the division by 0 included (no plain version codes
    these)."""
    rng = np.random.default_rng(N)
    for trial in range(4):
        table = rng.integers(-2 ** 31, 2 ** 31, (5, 9)).astype(np.int32)
        if trial == 1:
            table[:, 4:] = table[:, 4:5]              # frequencies 0
        table = torch.as_tensor(table, device=card)
        args = (torch.as_tensor(rng.integers(-3, 12, (2, 77, N)).astype(
                    np.int32), device=card),
                torch.as_tensor(rng.integers(-2, 8, (2, 77, N)).astype(
                    np.int32), device=card),
                torch.as_tensor(rng.integers(0, N + 1, 77).astype(np.int32),
                                device=card), table)
        got = re_.rans_encode_all_multi(*args, num_lanes=N)
        want = re_.rans_encode_all_multi_rowsync(*args, num_lanes=N)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_encode_counts_one_launch_a_call_and_chain_phase_repeats(card):
    """A wrapper call counts one launch though the encode makes four; the
    chain phase rerun alone (chain_phase) gives the encode's states, and
    its register-only bound runs."""
    table = cdf.build_cdf_table(cdf.default_gaussian_scale_table())
    cdfs = torch.as_tensor(rd.prepare_device_cdf(table)[0], device=card)
    vals, idxs = _blocks(np.random.default_rng(3), [300, 7, 129, 5000])
    sym_rows, idx_rows, row_n = re_.blocks_to_rows(vals, idxs, 64)
    syms = torch.as_tensor(np.stack([sym_rows] * 2), device=card).clamp(0, 3)
    idx = torch.as_tensor(np.stack([idx_rows] * 2), device=card)
    before = (re_.rans_encode_all.launches, re_.rans_encode_all_multi.launches)
    _, _, states = re_.rans_encode_all_multi(syms, idx, row_n, cdfs,
                                             num_lanes=64)
    re_.rans_encode_all(syms[0], idx[0], row_n, cdfs, num_lanes=64)
    assert (re_.rans_encode_all.launches,
            re_.rans_encode_all_multi.launches) == (before[0] + 1,
                                                    before[1] + 1)
    chain = re_.chain_phase(syms, idx, row_n, cdfs)
    assert torch.equal(chain(), states) and torch.equal(chain(), states)
    re_.chain_phase(syms, idx, row_n, cdfs, registers_only=True)()
    torch.cuda.synchronize()


# ---- the lossless pixel head -----------------------------------------------

def _nll_inputs(rng, card, shape=(2, 48, 80, 3)):
    """Means on the pixel grid's half-points moved by up to 3 ulps (a fifth
    of them random in [-3, 3]); raw scales on the head table's entries
    moved by up to 4 ulps (a tenth of them random in [-12, 3])."""
    from lvae_tpu_torch.ops import cdf
    n = int(np.prod(shape))
    table = cdf.lossless_head_scale_table().astype(np.float32)
    m = ((rng.integers(-3, 259, n) + 0.5) / 127.5 - 1).astype(np.float32)
    r = (np.log(table[rng.integers(0, 128, n)].astype(np.float64))
         + np.log(1 / 127.5)).astype(np.float32)
    for x, k in ((m, 3), (r, 4)):
        x += rng.integers(-k, k + 1, n) * np.spacing(x)
    wild = rng.random(n) < 0.2
    m[wild] = rng.uniform(-3, 3, int(wild.sum()))
    wild &= rng.random(n) < 0.5
    r[wild] = rng.uniform(-12, 3, int(wild.sum()))
    t = [torch.as_tensor(a.reshape(shape), device=card) for a in (m, r)]
    return t[0], t[1], torch.as_tensor(table, device=card)


def test_nll_kernels_match_plain_bitwise(card):
    """nll_head and nll_recon against their plain versions bitwise (pm,
    indexes, pixels), one launch counted per call, and one image of a batch
    of two getting the bits it gets alone."""
    from lvae_tpu_torch.ops import trunk
    rng = np.random.default_rng(0)
    m, r, table = _nll_inputs(rng, card)
    before = trunk.nll_head.launches
    pm, idx = trunk.nll_head(m, r, table, 1 / 127.5)
    assert trunk.nll_head.launches == before + 1
    want_pm, want_idx = trunk.nll_head_plain(m, r, table, 1 / 127.5)
    assert torch.equal(pm, want_pm) and torch.equal(idx, want_idx)
    assert idx.unique().numel() == 128
    pm1, idx1 = trunk.nll_head(m[1:].contiguous(), r[1:].contiguous(), table,
                               1 / 127.5)
    assert torch.equal(pm1, pm[1:]) and torch.equal(idx1, idx[1:])
    syms = torch.as_tensor(rng.integers(-300, 301, m.shape).astype(np.int32),
                           device=card)
    for mean in (pm, m * 300):
        before = trunk.nll_recon.launches
        got = trunk.nll_recon(syms, mean, 1 / 127.5)
        assert trunk.nll_recon.launches == before + 1
        want = trunk.nll_recon_plain(syms, mean, 1 / 127.5)
        assert got.dtype == torch.float32 and torch.equal(got, want)
        assert float(got.min()) == 0 and float(got.max()) == 255


def test_portable_qres_tiny_lossless_roundtrip_on_card(card):
    """qres_tiny_lossless at 128x192 on the portable trunk, the head's
    scales spread over its table and the posteriors x300: the pixels come
    back exact, single and in a batch of two, and the head's kernels launch
    once an encode (nll_head) and once each a decode (plus nll_recon in the
    self-check)."""
    from lvae_tpu_torch.ops import trunk
    torch.manual_seed(0)
    model = lvae_tpu_torch.get_model('qres_tiny_lossless')
    with torch.no_grad():
        for name, p in model.net.named_parameters():
            if name.endswith('posterior.c4.weight'):
                p.mul_(300.0)
        conv = model.net.out_net.conv_scale.conv
        conv.weight.mul_(0.2)
        conv.bias.uniform_(-7.0, -2.0)
    model.compress_mode(portable=True, esc_cap=1 << 17)
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (2, 128, 192, 3)).astype(np.uint8)
    ims = u8.astype(np.float32) / 255.0
    heads = (trunk.nll_head, trunk.nll_recon, trunk.upsample_head,
             trunk.dense)
    before = {k: k.launches for k in heads}
    obj, recon = model.compress_check(ims[:1])
    dec = model.decompress(obj)
    assert np.array_equal(dec, ims[:1]) and np.array_equal(recon, ims[:1])
    assert trunk.nll_head.launches - before[trunk.nll_head] == 2
    assert trunk.nll_recon.launches - before[trunk.nll_recon] == 2
    # the head's two convs: one upsample_head launch a direction, no dense
    # (qres_tiny_lossless's trunk has two upsample convs)
    assert trunk.upsample_head.launches - before[trunk.upsample_head] == 2
    assert trunk.dense.launches - before[trunk.dense] == 2 * 2
    img = model.decompress_to_device(obj[0], *obj[1][1:3])
    assert img.dtype == torch.uint8
    assert np.array_equal(img.cpu().numpy(), u8[:1])
    objs = model.compress_batch(ims)
    assert np.array_equal(model.decompress_batch(objs), ims)
    assert objs[0][0] == obj[0]


# ---- upsample_finish and upsample_head against their chains ---------------

# (B, H, W) grids: rows 1, 95, 385, 24576 and 49152 (every tile of
# dispatch_shuffle at N = 48 and 96); B = 2 and 6 (a tile straddles grid
# rows and images); rates 4 (the models'), 2 and 1 (the 16x24 tiles) and 3
# (the element-by-element write)
SHUFFLE_GRIDS = ((1, 1, 1), (1, 5, 19), (1, 11, 35), (2, 5, 19),
                 (6, 5, 19), (1, 128, 192), (2, 128, 192))
SHUFFLE_RATES = (4, 2, 1, 3)
# bias values whose finish is a float16 tie (0.5 + odd * 2^-12, 0.25 +
# odd * 2^-13), +-1, NaN, +-inf and +-0
SHUFFLE_SPECIALS = np.array(
    [2.0 ** -11, 3 * 2.0 ** -11, -0.5 + 2.0 ** -12, -0.5 + 3 * 2.0 ** -12,
     1.0, -1.0, np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32)


def _shuffle_case(rng, card, name, B, H, W, C, rate, unaligned):
    """x (B, H, W, C) (rows 4 bytes off 16 when `unaligned`; where M >= 3 a
    zero row, whose outputs are the bias alone, a NaN/+-inf/+-1 row and a
    +-1 row), and each conv's weight and bias, every even bias column one
    of SHUFFLE_SPECIALS."""
    M, G = B * H * W, 3 * rate * rate
    x = rng.normal(size=M * C + 1).astype(np.float32)
    x = (x[1:] if unaligned else x[:-1]).reshape(M, C)
    if M >= 3:
        x[0] = 0.0
        x[M // 2] = np.resize(np.array([np.nan, np.inf, -np.inf, 1, -1],
                                       np.float32), C)
        x[-1] = np.where(np.arange(C) % 3 == 0, -1.0, 1.0)
    buf = torch.zeros(M * C + 1, device=card)
    xt = (buf[1:] if unaligned else buf[:-1]).view(B, H, W, C)
    xt.copy_(torch.as_tensor(x.reshape(B, H, W, C)))
    args = [xt]
    for _ in range(1 if name == 'upsample_finish' else 2):
        w = rng.normal(size=(C, G)).astype(np.float32) * C ** -0.5
        b = (rng.normal(size=G) * 0.5).astype(np.float32)
        b[::2] = np.resize(SHUFFLE_SPECIALS, b[::2].size)
        args += [torch.as_tensor(w, device=card),
                 torch.as_tensor(b, device=card)]
    return args + [rate]


def _bits(t):
    """The tensor's bits (NaNs and the sign of zero compare)."""
    return t.view({torch.float32: torch.int32,
                   torch.float16: torch.int16}[t.dtype])


@pytest.mark.parametrize('name', ['upsample_finish', 'upsample_head'])
@pytest.mark.parametrize('C', [8, 10, 128, 192])
def test_upsample_fold_equals_chain_ragged(card, name, C):
    """upsample_finish and upsample_head bitwise against the chains they
    fold (dense, the shuffle copy, finish_image and
    the float16 cast; two dense and two shuffles) at every grid of
    SHUFFLE_GRIDS and rate of SHUFFLE_RATES, at rate 4 also from rows 4
    bytes off 16; each image of a batch against its bits alone; one launch
    counted a call; outputs contiguous, (B, rH, rW, 3), float16 or
    float32."""
    from lvae_tpu_torch.ops import trunk
    rng = np.random.default_rng(C)
    fn, chain = getattr(trunk, name), getattr(trunk, name + '_chain')
    for B, H, W in SHUFFLE_GRIDS:
        for rate in SHUFFLE_RATES:
            for unaligned in ((False, True) if rate == 4 and C % 4 == 0
                              else (False,)):
                case = (B, H, W, rate, unaligned)
                args = _shuffle_case(rng, card, name, B, H, W, C, rate,
                                     unaligned)
                before = fn.launches
                got = fn(*args)
                assert fn.launches == before + 1, case
                outs = [got] if name == 'upsample_finish' else list(got)
                want = chain(*args)
                want = [want] if name == 'upsample_finish' else list(want)
                for o, w in zip(outs, want):
                    assert o.is_contiguous() and o.shape == (
                        B, rate * H, rate * W, 3), case
                    assert o.dtype == (torch.float16 if name ==
                                       'upsample_finish' else torch.float32)
                    assert torch.equal(_bits(o), _bits(w)), case
                for b in range(B if B > 1 else 0):
                    alone = fn(args[0][b:b + 1], *args[1:])
                    alone = [alone] if name == 'upsample_finish' else alone
                    assert all(torch.equal(_bits(o[b:b + 1]), _bits(a))
                               for o, a in zip(outs, alone)), (case, b)


def test_golden_streams_decode_to_recorded_bits(card):
    """The portable streams of tests/golden/, written on the card by an
    earlier commit (scripts/write-golden-streams.py), decode with
    decompress_file to the recorded sha256 (chip_smoke.check_golden):
    qarv_base's float16 image of photo1 at lambda 2048, and
    qres34m_lossless's pixels of the 256 crop, which are the crop's own. A
    CPU decode runs the plain products in another sum order and is not
    expected to match: the test needs the card."""
    import chip_smoke
    qarv = lvae_tpu_torch.get_model('qarv_base',
                                    pretrained=chip_smoke.CHECKPOINT)
    qarv.compress_mode(num_lanes='auto', portable=True)
    lossless = chip_smoke.build_qres34m(torch, 'qres34m_lossless')
    lossless.compress_mode(portable=True, num_lanes=chip_smoke.QRES_LANES,
                           esc_cap=chip_smoke.LOSSLESS_ESC_CAP)
    res = chip_smoke.check_golden(
        torch, {'qarv_base': qarv, 'qres34m_lossless': lossless}, None)
    assert all(r['match'] and r['file_intact']
               for r in res['streams'].values())


@pytest.mark.parametrize('name', ['qarv_tiny', 'qres_tiny',
                                  'qres_tiny_lossless'])
def test_forward_on_the_card_equals_the_cpu(card, name, tmp_path):
    """The eval forward (library convolutions, exact float32 whatever the
    TF32 flags) on the card against the same weights on the CPU: stats at
    rtol 1e-3, PSNR within 0.01 dB, each latent block's kl at 1e-3 plus the
    mass's float32 error (2e-7) through the log; then self_evaluate
    (qarv_tiny) and image_self_evaluate on a 100 x 90 and a 128 x 128 PNG."""
    from chip_smoke import write_png
    from lvae_tpu_torch import evaluation
    torch.manual_seed(0)
    cpu = lvae_tpu_torch.get_model(name, device='cpu')
    gpu = lvae_tpu_torch.get_model(name)
    gpu.net.load_state_dict(cpu.net.state_dict())
    rng = np.random.default_rng(4)
    im = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    kw = {'lmb': [16.0, 2048.0]} if name == 'qarv_tiny' else {}
    want, got = cpu.forward(im, **kw), gpu.forward(im, **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        tol = 0.01 if k == 'psnr' else 1e-3 * abs(v)
        assert abs(got[k] - v) <= tol, (k, got[k], v)
    x = torch.from_numpy(im).permute(0, 3, 1, 2)
    with torch.no_grad():
        if name == 'qarv_tiny':
            lmb = torch.tensor([16.0, 2048.0])
            lat_c = cpu.net.forward_end2end(x, lmb)[1]
            lat_g = gpu.net.forward_end2end(x.cuda(), lmb.cuda())[1]
        else:
            lat_c = cpu.net.forward(x)[2]
            lat_g = gpu.net.forward(x.cuda())[2]
    for a, b in zip(lat_c, lat_g):
        kl_c, kl_g = a['kl'].double(), b['kl'].cpu().double()
        assert (torch.abs(kl_g - kl_c)
                <= 1e-3 + torch.clamp(2e-7 * torch.exp(kl_c), max=21)).all()
    for i, (h, w) in enumerate([(100, 90), (128, 128)]):
        write_png(tmp_path / f'im{i}.png',
                  rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    if name == 'qarv_tiny':
        want = cpu.self_evaluate(tmp_path, lmb_range=(16, 2048), steps=2,
                                 shape_buckets=2)
        got = gpu.self_evaluate(tmp_path, lmb_range=(16, 2048), steps=2,
                                shape_buckets=2)
        assert got['lambda'] == want['lambda']
        assert np.allclose(got['bpp'], want['bpp'], rtol=1e-3)
        assert np.allclose(got['psnr'], want['psnr'], rtol=0, atol=0.01)
    want = evaluation.image_self_evaluate(cpu, str(tmp_path), progress=False)
    got = evaluation.image_self_evaluate(gpu, str(tmp_path), progress=False)
    assert abs(got['psnr'] - want['psnr']) <= 0.01
    assert abs(got['bppix'] - want['bppix']) <= 1e-3 * want['bppix']


def test_eval_var_rate_on_the_card(card, tmp_path, monkeypatch):
    """The CLI runs on the card by default and writes the card's name and
    power limit as nvidia-smi prints them."""
    from chip_smoke import write_png
    from lvae_tpu_torch import eval_var_rate
    rng = np.random.default_rng(6)
    (tmp_path / 'set').mkdir()
    write_png(tmp_path / 'set' / 'a.png',
              rng.integers(0, 256, (64, 96, 3), dtype=np.uint8))
    monkeypatch.chdir(tmp_path)
    out = eval_var_rate.main(['-m', 'qarv_tiny', '-n', 'set', '-s', '2'])
    saved = (tmp_path / 'runs' / 'results' / 'set-qarv_tiny.json')
    assert saved.is_file() and len(out['lambdas']) == 2
    assert out['device'].startswith(torch.cuda.get_device_name(0))
    assert all(v > 0 for v in out['results']['bpp'])


# ---- the staged coders (coder='host' and 'device') and qres17m -----------

def test_native_coder_equals_numpy_on_the_card_machine(card):
    """The g++-built host coder (ops/crans.py) on the card's machine: its
    bytes those of the numpy coder, its N-lane streams those of the numpy
    interleaved encoder."""
    from lvae_tpu_torch.ops import crans, rans_interleaved, rans_numpy
    table = cdf.build_cdf_table(cdf.qres_latent_scale_table())
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 64, 3000).astype(np.int32)
    vals = np.round(rng.normal(0, table.scale_table[idx])).astype(np.int32)
    vals[::97] = rng.integers(-(2 ** 30), 2 ** 30, vals[::97].size)
    data = crans.encode_with_indexes(vals, idx, table)
    assert data == rans_numpy.encode_with_indexes(vals, idx, table)
    assert np.array_equal(crans.decode_with_indexes(data, idx, table), vals)
    got = crans.interleaved_encode(vals, idx, [1000, 0, 2000], table, 128)
    enc = rans_interleaved.InterleavedEncoder(table, 128)
    for a, b in ((0, 1000), (1000, 1000), (1000, 3000)):
        enc.append_block(vals[a:b], idx[a:b])
    for a, b in zip(got, enc.finish()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize('name', ['qarv_tiny', 'qres_tiny'])
def test_device_coder_decode_equals_host_decode_on_card(card, name):
    """The device coder's decode (kernel #1 once a latent block) equals
    the host coder's and the legacy fused codec's reconstruction bitwise,
    with escapes."""
    torch.manual_seed(0)
    model = lvae_tpu_torch.get_model(name)
    with torch.no_grad():
        for pname, p in model.net.named_parameters():
            if pname.endswith(('posterior.weight', 'posterior.c4.weight')):
                p.mul_(300.0)                        # make escapes occur
    kw = {} if name.startswith('qres') else {'lmb': 1024.0}
    im = np.random.default_rng(0).uniform(0, 1, (1, 128, 192, 3))
    model.compress_mode(num_lanes=128, esc_cap=1 << 16)
    _, legacy = model.compress_check(im, portable=False, **kw)
    recs = {}
    for coder in ('host', 'device'):
        model.compress_mode(coder=coder)
        obj, recon = model.compress_check(im, **kw)
        launches = rd.rans_decode_block.launches
        recs[coder] = model.decompress(obj)
        assert np.array_equal(recs[coder], recon)
        assert rd.rans_decode_block.launches - launches == (
            (3 if name == 'qres_tiny' else 2) if coder == 'device' else 0)
    assert np.array_equal(recs['host'], legacy)
    assert np.array_equal(recs['device'], legacy)


def test_qres17m_legacy_batch_roundtrip_on_card(card):
    """qres17m at full width (flax-style random weights, seed 0) on the
    legacy fused codec: B = 2 exact against encode_check_batch, and each
    image's single stream exact; the portable trunk refused."""
    from lvae_tpu_torch.models import common
    model = lvae_tpu_torch.get_model('qres17m')
    common.flax_init_(model.net, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match='deconv'):
        model.compress_mode(portable=True)
    model.compress_mode(esc_cap=1 << 18)
    ims = np.random.default_rng(1).uniform(0, 1, (2, 128, 192, 3)).astype(
        np.float32)
    objs = model.compress_batch(ims)
    bodies, recon = model._fused.encode_check_batch(
        torch.as_tensor(ims, device=card).permute(0, 3, 1, 2).contiguous())
    assert [o[0] for o in objs] == bodies
    assert np.array_equal(model.decompress_batch(objs), recon)
    obj, rec1 = model.compress_check(ims[:1])
    assert np.array_equal(model.decompress(obj), rec1)


def test_rd_forward_on_the_card_equals_the_cpu(card):
    """rd_tiny's training forward on the card against the same weights on
    the CPU, on the same noise (drawn on the CPU from one seed and copied to
    the card: a CUDA generator draws other normals): bppix and loss rtol
    1e-4, PSNR within 1e-3 dB; t = 0 samples within 1e-4."""
    torch.manual_seed(0)
    cpu = lvae_tpu_torch.get_model('rd_tiny', device='cpu')
    gpu = lvae_tpu_torch.get_model('rd_tiny')
    gpu.net.load_state_dict(cpu.net.state_dict())
    im = np.random.default_rng(4).uniform(0, 1, (2, 128, 128, 3)).astype(
        np.float32)
    kw = dict(lmb=[4.0, 2048.0])
    want = cpu.forward(im, generator=torch.Generator().manual_seed(3), **kw)
    got = gpu.forward(im, generator=torch.Generator().manual_seed(3), **kw)
    for k in ('bppix', 'loss'):
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), k
    assert abs(got['psnr'] - want['psnr']) <= 1e-3
    a = cpu.unconditional_sample(64.0, (2, 1, 1), t=0.0)
    b = gpu.unconditional_sample(64.0, (2, 1, 1), t=0.0)
    assert np.abs(a - b).max() <= 1e-4


@pytest.mark.parametrize('name', ['qarv_tiny', 'qres_tiny',
                                  'qres_tiny_lossless'])
def test_cond_sample_on_own_latents_equals_reconstruct_on_card(card, name):
    """On the card, the decoder on forward_get_latents' z gives the eval
    reconstruction bitwise (the lossless head at temperature 0: its
    means); inpaint repeats bitwise for a seed."""
    torch.manual_seed(0)
    m = lvae_tpu_torch.get_model(name)
    im = np.random.default_rng(5).uniform(0, 1, (1, 128, 128, 3)).astype(
        np.float32)
    if name == 'qarv_tiny':
        z = [st['z'] for st in m.forward_get_latents(im, 512.0)]
        assert np.array_equal(m.conditional_sample(512.0, z),
                              m.reconstruct(im, 512.0))
        return
    z = [st['z'] for st in m.forward_get_latents(im)]
    got = m.cond_sample(z, temprature=0.0 if m.lossless else 1.0)
    assert np.array_equal(got, m.reconstruct(im))
    box = (0.25, 0.25, 0.75, 0.75)
    a = m.inpaint(im, box, steps=2, seed=1)
    assert np.isfinite(a).all()
    assert np.array_equal(a, m.inpaint(im, box, steps=2, seed=1))


# ---- the bf16 encoder backbone and training on the card --------------------

@pytest.mark.parametrize('name', ['qarv_tiny', 'qres_tiny'])
@pytest.mark.parametrize('portable', [False, True])
def test_bf16_backbone_round_trips_on_card(card, name, portable):
    """compress_mode(compute_dtype='bfloat16') on the card: B = 1 and B = 2
    round trips bit-exact on both trunks, and the trunk kernels launched as
    often as at float32."""
    from lvae_tpu_torch.ops import trunk
    torch.manual_seed(0)
    m = lvae_tpu_torch.get_model(name)
    with torch.no_grad():
        for pname, p in m.net.named_parameters():
            if pname.endswith(('posterior.weight', 'posterior.c4.weight')):
                p.mul_(300.0)
    ims = np.random.default_rng(2).uniform(0, 1, (2, 128, 128, 3)).astype(
        np.float32)
    kw = dict(lmb=512.0) if name == 'qarv_tiny' else {}
    counted = [f for f in vars(trunk).values() if hasattr(f, 'launches')]
    launches = {}
    for cd in (None, 'bfloat16'):
        m.compress_mode(num_lanes=16, portable=portable, compute_dtype=cd)
        before = {f: f.launches for f in counted}
        stream, recon = m.compress_check(ims[:1], **kw)
        launches[cd] = {f.__name__: f.launches - before[f] for f in counted}
        assert np.array_equal(m.decompress(stream), recon)
        objs = m.compress_batch(ims, **kw)
        _, want = m._fused.encode_check_batch(
            torch.from_numpy(ims).permute(0, 3, 1, 2).contiguous().cuda(),
            *((torch.full((2,), 512.0, device='cuda'),) if kw else ()))
        assert np.array_equal(m.decompress_batch(objs), want)
    assert launches[None] == launches['bfloat16']
    assert m._fused.compute_dtype == torch.bfloat16


@pytest.mark.parametrize('amp', [False, True])
def test_one_train_step_on_card(card, amp, tmp_path, monkeypatch):
    """Two steps of train_fix_rate at qres_tiny on the card (f32 under
    exact_f32, or --amp --remat): finite losses and grad norms, the
    parameters moved, and the process's TF32 flags as they were."""
    from lvae_tpu_torch import train_fix_rate
    from lvae_tpu_torch.utils import coding
    d = tmp_path / 'set'
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        coding.write_png(d / f'{i}.png', rng.integers(0, 256, (96, 96, 3),
                                                      dtype=np.uint8))
    monkeypatch.chdir(tmp_path)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    argv = ['--model', 'qres_tiny', '--model_args', 'lmb=64',
            '--trainset', str(d), '--valset', str(d), '--transform',
            'crop=64,hflip=True', '--batch_size', '2', '--workers', '1',
            '--iterations', '2', '--lr_warmup', '0', '--val_interval', '0',
            '--probe_device_step'] + (['--amp', '--remat'] if amp else [])
    t = train_fix_rate.main(argv)
    assert t.device.type == 'cuda' and t.state.flat.is_cuda
    assert len(t.history) == 2 and all(
        np.isfinite(h['loss']) and np.isfinite(h['grad_norm'])
        for h in t.history)
    assert t._device_step_ms > 0 and t._step_flops > 0
    assert (flags == (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32))
    assert (t._log_dir / 'last').is_file()


_CARD_RANK = r'''
import hashlib, json, sys
import numpy as np
import torch
import lvae_tpu_torch
from lvae_tpu_torch import parallel
from lvae_tpu_torch.models.base import exact_f32
from lvae_tpu_torch.parallel import dist_utils
from lvae_tpu_torch.training.optim import TrainState, make_train_step

work = sys.argv[1]
device = parallel.init_distributed(backend='gloo', device='cuda:0')
rank = parallel.process_index()
out = {}
# the halo exchange and its gradient: a 7x7 / 5x5 stride-2 deconv / 3x3
# stack in float64, H split over the two ranks
torch.manual_seed(3)
net = torch.nn.Sequential(
    torch.nn.Conv2d(3, 8, 7, padding=3), torch.nn.GELU(),
    torch.nn.ConvTranspose2d(8, 8, 5, stride=2, padding=2, output_padding=1),
    torch.nn.Conv2d(8, 4, 3, padding=1)).double().to(device)
g = torch.Generator().manual_seed(5)
x = torch.randn(2, 3, 16, 8, generator=g, dtype=torch.float64).to(device)
w = torch.randn(2, 4, 32, 16, generator=g, dtype=torch.float64).to(device)
mesh = parallel.get_2d_mesh(1, 2)
sh = parallel.Sharding(mesh, (None, None, 'space'))
xs = sh.local(x).clone().requires_grad_()
with parallel.sharded(mesh):
    y = net(xs)
grads = torch.autograd.grad((y * sh.local(w)).sum(), [xs, net[0].weight])
torch.distributed.all_reduce(grads[1])
x = x.clone().requires_grad_()
want = torch.autograd.grad((net(x) * w).sum(), [x, net[0].weight])
out['halo'] = [float((y - sh.local(net(x))).abs().max()),
               float((grads[0] - sh.local(want[0])).abs().max()),
               float((grads[1] - want[1]).abs().max())]

# the data-parallel step on qres_tiny, 2 ranks x 2 images
model = lvae_tpu_torch.get_model('qres_tiny', device=device)
model.net.load_state_dict(torch.load(f'{work}/weights.pt',
                                     weights_only=True))
state = TrainState(model.net, optimizer='adam', ema=True)
dmesh = parallel.get_data_mesh()
step = make_train_step(
    lambda b, g: model.loss_and_stats(b, training=True, generator=g),
    state, grad_clip=2.0, mesh=dmesh)
batch = parallel.shard_batch(np.load(f'{work}/batch.npy'), dmesh,
                             device=device).permute(0, 3, 1, 2).contiguous()
with exact_f32():
    for i in range(2):
        m = step(batch, torch.Generator(device).manual_seed(42 + i), 1e-3,
                 1e9, 0.9)
out['loss'] = float(m['loss'])
out['equal'] = dist_utils.check_model_equivalence(state, dmesh)
if rank == 0:
    torch.save({'flat': state.flat.cpu(), 'ema': state.ema.cpu()},
               f'{work}/dp.pt')
print('RESULT ' + json.dumps(out), flush=True)
'''


def test_halo_exchange_and_dp_step_at_two_gloo_ranks_on_card(card,
                                                             tmp_path):
    """Two gloo ranks sharing the card (tests/torch_ranks.py): the halo
    exchange's forward and gradient against the unsharded stack, and the
    data-parallel step on qres_tiny, its ranks bitwise equal and within
    atol 5e-6 of the one-process step on the card."""
    import json

    import torch_ranks
    from lvae_tpu_torch.training.optim import TrainState, make_train_step
    torch.manual_seed(0)
    model = lvae_tpu_torch.get_model('qres_tiny', device=card)
    torch.save(model.net.state_dict(), tmp_path / 'weights.pt')
    batch = np.random.default_rng(3).uniform(0, 1, (4, 64, 64, 3)).astype(
        np.float32)
    np.save(tmp_path / 'batch.npy', batch)
    script = tmp_path / 'rank.py'
    script.write_text(_CARD_RANK)
    outs = torch_ranks.launch(script, 2, args=(tmp_path,), timeout=240)
    r0, r1 = (json.loads(next(l for l in o.splitlines()
                              if l.startswith('RESULT '))[7:]) for o in outs)
    assert max(r0['halo']) < 1e-10 and max(r1['halo']) < 1e-10
    assert r0['loss'] == r1['loss'] and r0['equal'] and r1['equal']
    state = TrainState(model.net, optimizer='adam', ema=True)
    step = make_train_step(
        lambda b, g: model.loss_and_stats(b, training=True, generator=g),
        state, grad_clip=2.0)
    x = torch.as_tensor(batch, device=card).permute(0, 3, 1, 2).contiguous()
    from lvae_tpu_torch.models.base import exact_f32
    with exact_f32():
        for i in range(2):
            m = step(x, torch.Generator(card).manual_seed(42 + i), 1e-3,
                     1e9, 0.9)
    assert r0['loss'] == pytest.approx(float(m['loss']), rel=1e-5)
    got = torch.load(tmp_path / 'dp.pt', weights_only=True)
    for k, want in (('flat', state.flat), ('ema', state.ema)):
        assert float((got[k] - want.cpu()).abs().max()) <= 5e-6, k
