"""Portable trunk kernels: every float between the stream's integer
junctions, computed by hand-written CUDA kernels whose results do not depend
on the process, the batch size or any library's algorithm choice.

Counterpart of ``lvae_tpu/ops/pallas/trunk.py`` (rows 5-19 of the kernel
table in PERF.md: the QARV trunk, the QRes-VAE trunk, then the lossless
pixel head). A rANS stream
desyncs when the decoder's recomputed prior floats differ from the
encoder's by one scale-index flip, so a stream that is to decode in another
process (a file) must see bitwise the same trunk floats
there. cuDNN and cuBLAS choose algorithms by shape, batch and global flags;
the kernels of ``csrc/trunk.cu`` do not: each output element's sum over K runs
in one fixed order (0..K-1, one fused multiply-add chain) that depends only on
the weights' shape, with no split-K and no atomics, and every row or pixel is
computed on its own, so the batch size and the row count only enter through
the ragged-edge mask. Everything outside the kernels is data movement (pad,
reshape, permute, pixel shuffle, concatenation), which is value-exact.

Each wrapper has the interface of the JAX function (NHWC features, weights
in the JAX (in, out) layout; a ``.t()`` view of a torch weight costs no copy)
and a plain PyTorch version beside it. A wrapper launches its kernel for
tensors on the card and runs the plain version only for tensors on the CPU;
``<wrapper>.launches`` counts its kernel launches.

The math is the JAX package's: GELU through the Abramowitz-Stegun erf
polynomial and softplus as max(x, 0) + log(1 + exp(-|x|)), not torch.erf or
F.softplus, so that the plain versions, the kernels and the reference compute
the same formulas.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F

from lvae_tpu_torch.ops import build


# ---------------------------------------------------------------------------
# shared math (lvae_tpu/ops/pallas/trunk.py:77-102)
# ---------------------------------------------------------------------------

def _erf(x):
    """erf via Abramowitz-Stegun 7.1.26 (max abs err 1.5e-7)."""
    s = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return s * (1.0 - poly * torch.exp(-ax * ax))


def _gelu(x):
    return 0.5 * x * (1.0 + _erf(x * 0.7071067811865476))


def _softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log(1.0 + torch.exp(-torch.abs(x)))


def emb_freqs(embed_dim, sin_period):
    """(1, embed_dim/2) float32 sinusoid frequencies, built with numpy as
    lvae_tpu/models/qarv/fused.py:106-108 builds them."""
    half = embed_dim // 2
    return np.power(float(sin_period),
                    -np.linspace(0.0, 1.0, half)).astype(np.float32)[None]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _mm(x, w):
    """x (B, M, K) @ w (K, N), one image at a time (torch.bmm), so that an
    image's rows get the bits they get alone, whatever B: ATen's CPU matmul
    of the folded (B*M, K) operand picks its kernel by B*M (one row takes
    the matrix-vector path), and a stream must decode alike alone or in a
    batch on the plain path too."""
    return torch.bmm(x, w.expand(x.shape[0], -1, -1))


def emb_mlp_plain(lmb, freqs, w0, b0, w1, b1, sin_period):
    scale = float(sin_period) / math.log(8192.0)
    args = (torch.log(lmb.reshape(-1, 1).float()) * scale) * freqs
    x = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)[:, None]
    x = _gelu(_mm(x, w0) + b0)
    emb = (_mm(x, w1) + b1)[:, 0]
    return emb, _gelu(emb)


def _dw_ln_plain(x, dwk, dwb, K):
    """K x K depthwise conv ('same') + bias, then LayerNorm over C (eps
    1e-6) without affine."""
    B, H, W, C = x.shape
    p = (K - 1) // 2
    xp = F.pad(x, (0, 0, p, p, p, p))
    y = torch.zeros_like(x) + dwb
    for di in range(K):
        for dj in range(K):
            y = y + xp[:, di:di + H, dj:dj + W, :] * dwk[di, dj]
    mu = y.mean(-1, keepdim=True)
    var = torch.square(y - mu).mean(-1, keepdim=True)
    return (y - mu) * (1.0 / torch.sqrt(var + 1e-6))


def dw_ln_mod_plain(x, dwk, dwb, ew, eb, gemb, kernel_size):
    C = x.shape[-1]
    y = _dw_ln_plain(x, dwk, dwb, kernel_size)
    e = _mm(gemb[:, None], ew)[:, 0] + eb
    shift, scale = e[:, None, None, :C], e[:, None, None, C:]
    return y * (1.0 + scale) + shift


def mlp_res_plain(t, w1, b1, w2, b2, gamma, shortcut):
    o = _mm(_gelu(_mm(t, w1) + b1), w2) + b2
    return shortcut + o * gamma


def dense_plain(x, w, b):
    return _mm(x, w) + b


def prior_scales_plain(x, w, b, table, act=False):
    """-> (pm, the clamped scales, scale indexes): prior_head's plain version
    with the scales it compares against the table."""
    Z = w.shape[1] // 2
    p = _mm(_gelu(x) if act else x, w) + b
    pm, plogv = p[..., :Z], p[..., Z:]
    pv = torch.exp(_softplus(plogv + 2.3) - 2.3)
    pv = torch.maximum(pv, table[0])
    idx = (table < pv[..., None]).sum(-1, dtype=torch.int32)
    return pm, pv, torch.clamp(idx, max=table.shape[0] - 1)


def prior_head_plain(x, w, b, table, act=False):
    pm, _, idx = prior_scales_plain(x, w, b, table, act)
    return pm, idx


def fuse_zproj_plain(feature, syms, pm, w, b):
    return feature + (_mm(syms.to(torch.float32) + pm, w) + b)


def finish_image_plain(x):
    return torch.clamp(x, -1.0, 1.0) * 0.5 + 0.5


def pixel_shuffle_nhwc(x, rate):
    """Depth-to-space on NHWC with torch.nn.PixelShuffle's channel order
    (lvae_tpu/models/common.py pixel_shuffle)."""
    B, H, W, CRR = x.shape
    C = CRR // (rate * rate)
    x = x.reshape(B, H, W, C, rate, rate).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * rate, W * rate, C)


def _conv_shuffle_plain(x, w, b, rate):
    """x (B, H, W, C) -> dense_plain -> pixel_shuffle_nhwc, contiguous:
    the plain path's patch_upsample."""
    B, H, W, C = x.shape
    y = dense_plain(x.reshape(B, H * W, C), w, b).reshape(B, H, W, -1)
    return pixel_shuffle_nhwc(y, rate).contiguous()


def upsample_finish_plain(x, w, b, rate):
    return finish_image_plain(_conv_shuffle_plain(x, w, b, rate)).to(
        torch.float16)


def upsample_head_plain(x, w_mean, b_mean, w_scale, b_scale, rate):
    return (_conv_shuffle_plain(x, w_mean, b_mean, rate),
            _conv_shuffle_plain(x, w_scale, b_scale, rate))


def dw_ln_affine_plain(x, dwk, dwb, scale, bias, kernel_size):
    return _dw_ln_plain(x, dwk, dwb, kernel_size) * scale + bias


def dense_act_plain(x, w, b, act=True):
    return _mm(_gelu(x) if act else x, w) + b


def conv_kxk_act_plain(x, wk, b, act=True):
    """As the JAX kernel accumulates: the first tap's product plus the
    bias, then each further tap's product added in (di, dj) order. GELU
    before the zero padding equals GELU of the padded window (gelu(0) is
    exactly 0)."""
    B, H, W, Ci = x.shape
    K = wk.shape[0]
    p = (K - 1) // 2
    xp = F.pad(_gelu(x) if act else x, (0, 0, p, p, p, p))
    out = None
    for di in range(K):
        for dj in range(K):
            y = _mm(xp[:, di:di + H, dj:dj + W, :].reshape(B, H * W, Ci),
                    wk[di, dj])
            out = y + b if out is None else out + y
    return out.reshape(B, H, W, wk.shape[-1])


def zadd_dense_plain(syms, pm, w, b):
    return _mm(syms.to(torch.float32) + pm, w) + b


def zadd_plain(syms, pm):
    return syms.to(torch.float32) + pm


def res_dense_act_plain(f, t, w, b):
    return (f + _mm(_gelu(t), w)) + b


def _divide(x, v):
    """x / float32(v), a true division: torch computes a division by a
    Python number on the card as a multiplication by its reciprocal. (The
    divisor is filled on the device, so a CUDA graph can capture it.)"""
    return x / torch.full((), v, dtype=torch.float32, device=x.device)


def nll_scales_plain(p_mean, p_scale_raw, table, bin_size):
    """-> (pm, the clamped scales, scale indexes): nll_head's plain version
    with the scales it compares against the table."""
    ls = _softplus(p_scale_raw + 16.0) - 16.0
    grid = torch.round(p_mean * 127.5 + 127.5)
    pm = _divide(_divide(grid, 127.5) - 1.0, bin_size)
    pv = torch.exp(ls - math.log(bin_size))
    pv = torch.maximum(pv, table[0])
    idx = (table < pv[..., None]).sum(-1, dtype=torch.int32)
    return pm, pv, torch.clamp(idx, max=table.shape[0] - 1)


def nll_head_plain(p_mean, p_scale_raw, table, bin_size):
    pm, _, idx = nll_scales_plain(p_mean, p_scale_raw, table, bin_size)
    return pm, idx


def nll_recon_plain(syms, pm, bin_size):
    x = (syms.to(torch.float32) + pm) * bin_size
    return torch.round((torch.clamp(x, -1.0, 1.0) * 0.5 + 0.5) * 255.0)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _on_card(name, *tensors):
    """True for CPU tensors' plain path, False for the card; raises for any
    other device or for inputs spread over devices."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f'{name}: inputs lie on different devices')
    if dev.type == 'cpu':
        return False
    if dev.type != 'cuda':
        raise ValueError(f'{name}: unsupported device {dev}')
    return True


def _f32(name, *tensors):
    """Contiguous float32 views (a copy only where the layout differs)."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f'{name}: expected float32, got {t.dtype}')
    return [t.contiguous() for t in tensors]


def _out_major(w):
    """(in, out) weight -> contiguous (out, in), the kernels' layout; free
    for the .t() view of a torch Linear/Conv weight."""
    return w.t().contiguous()


def _launch(name, fn, *args, device):
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    err = fn(*args, idx, torch.cuda.current_stream(device).cuda_stream)
    build.check(err, name)


def _emb_mlp_launch(entry, lmb, freqs, w0, b0, w1, b1, sin_period):
    B = lmb.numel()
    E0, E = w0.shape
    if freqs.numel() * 2 != E0 or w1.shape != (E, E):
        raise ValueError('emb_mlp: bad freqs/w0/w1 shapes')
    lmb, freqs, b0, b1 = _f32('emb_mlp', lmb, freqs, b0, b1)
    w0t, w1t = _f32('emb_mlp', _out_major(w0), _out_major(w1))
    emb = torch.empty((B, E), dtype=torch.float32, device=lmb.device)
    gemb = torch.empty_like(emb)
    scale = float(sin_period) / math.log(8192.0)
    _launch('emb_mlp', entry, lmb.data_ptr(), B, freqs.data_ptr(),
            w0t.data_ptr(), b0.data_ptr(), w1t.data_ptr(), b1.data_ptr(), E0,
            E, scale, emb.data_ptr(), gemb.data_ptr(),
            device=lmb.device)
    return emb, gemb


def emb_mlp(lmb, freqs, w0, b0, w1, b1, sin_period):
    """lmb (B,) -> (emb (B, E), gelu(emb) (B, E)): log-lambda sinusoid ->
    Linear -> GELU -> Linear. freqs (1, E0/2); w0 (E0, E); w1 (E, E). On the
    card one launch of a thread-block cluster of 16 CTAs, each holding a
    slice of both weights in shared memory."""
    if not _on_card('emb_mlp', lmb, freqs, w0, b0, w1, b1):
        return emb_mlp_plain(lmb, freqs, w0, b0, w1, b1, sin_period)
    out = _emb_mlp_launch(build.library().trunk_emb_mlp, lmb, freqs, w0, b0,
                          w1, b1, sin_period)
    emb_mlp.launches += 1
    return out


def emb_mlp_cluster8(lmb, freqs, w0, b0, w1, b1, sin_period):
    """emb_mlp's cluster kernel on the portable cluster of 8 CTAs: the
    yardstick of the main path's 16 and a second partition for its bitwise
    checks (chip_smoke.py, the card tests); not on the main path, and not
    counted in emb_mlp.launches."""
    if not _on_card('emb_mlp', lmb, freqs, w0, b0, w1, b1):
        return emb_mlp_plain(lmb, freqs, w0, b0, w1, b1, sin_period)
    return _emb_mlp_launch(build.library().trunk_emb_mlp_cluster8, lmb,
                           freqs, w0, b0, w1, b1, sin_period)


def emb_mlp_oneblock(lmb, freqs, w0, b0, w1, b1, sin_period):
    """emb_mlp on the one-block-a-row kernel (the weight rows read from
    device memory, one dependent trip an output): the bitwise oracle of
    emb_mlp's cluster kernel in chip_smoke.py and the card tests; not on the
    main path, and not counted in emb_mlp.launches."""
    if not _on_card('emb_mlp', lmb, freqs, w0, b0, w1, b1):
        return emb_mlp_plain(lmb, freqs, w0, b0, w1, b1, sin_period)
    return _emb_mlp_launch(build.library().trunk_emb_mlp_oneblock, lmb,
                           freqs, w0, b0, w1, b1, sin_period)


def _dw_ln_mod_launch(entry, x, dwk, dwb, ew, eb, gemb, kernel_size):
    B, H, W, C = x.shape
    K = int(kernel_size)
    E = ew.shape[0]
    if (dwk.shape != (K, K, C) or ew.shape != (E, 2 * C)
            or gemb.shape != (B, E) or K % 2 != 1):
        raise ValueError('dw_ln_mod: bad weight/embedding shapes')
    x, dwb, eb, gemb = _f32('dw_ln_mod', x, dwb, eb, gemb)
    # channel-major (C, K, K), as torch stores a depthwise conv weight
    dwk_c, ewt = _f32('dw_ln_mod', dwk.permute(2, 0, 1), _out_major(ew))
    out = torch.empty_like(x)
    # scratch: (B, 2C) modulation, then the (K*K, C) tap-major weights
    scratch = torch.empty(B * 2 * C + K * K * C, dtype=torch.float32,
                          device=x.device)
    _launch('dw_ln_mod', entry, x.data_ptr(), B, H, W, C, K,
            dwk_c.data_ptr(), dwb.data_ptr(), ewt.data_ptr(), eb.data_ptr(),
            gemb.data_ptr(), E, scratch.data_ptr(), out.data_ptr(),
            device=x.device)
    return out


def dw_ln_mod(x, dwk, dwb, ew, eb, gemb, kernel_size):
    """K x K depthwise conv ('same', zero padding) + bias -> LayerNorm over C
    (eps 1e-6, no affine) -> y * (1 + scale) + shift, (shift, scale) =
    gemb @ ew + eb. x (B, H, W, C), C <= 512; dwk (K, K, C), K odd; ew
    (E, 2C); gemb (B, E)."""
    if not _on_card('dw_ln_mod', x, dwk, dwb, ew, eb, gemb):
        return dw_ln_mod_plain(x, dwk, dwb, ew, eb, gemb, kernel_size)
    out = _dw_ln_mod_launch(build.library().trunk_dw_ln_mod, x, dwk, dwb, ew,
                            eb, gemb, kernel_size)
    dw_ln_mod.launches += 1
    return out


def dw_ln_mod_warp(x, dwk, dwb, ew, eb, gemb, kernel_size):
    """dw_ln_mod on the warp-per-pixel kernel (one warp a pixel, its K*K
    neighbours read from global memory): the bitwise oracle of dw_ln_mod's
    halo-tile kernel in chip_smoke.py and the card tests; not on the main
    path, and not counted in dw_ln_mod.launches."""
    if not _on_card('dw_ln_mod', x, dwk, dwb, ew, eb, gemb):
        return dw_ln_mod_plain(x, dwk, dwb, ew, eb, gemb, kernel_size)
    return _dw_ln_mod_launch(build.library().trunk_dw_ln_mod_warp, x, dwk,
                             dwb, ew, eb, gemb, kernel_size)


def mlp_res(t, w1, b1, w2, b2, gamma, shortcut):
    """shortcut + gamma * fc2(gelu(fc1(t))); t (B, HW, C), shortcut
    (B, HW, CO); w1 (C, HID), w2 (HID, CO)."""
    if not _on_card('mlp_res', t, w1, b1, w2, b2, gamma, shortcut):
        return mlp_res_plain(t, w1, b1, w2, b2, gamma, shortcut)
    B, HW, C = t.shape
    HID, CO = w1.shape[1], w2.shape[1]
    if w1.shape[0] != C or w2.shape[0] != HID \
            or shortcut.shape != (B, HW, CO):
        raise ValueError('mlp_res: bad weight/shortcut shapes')
    t, b1, b2, gamma, shortcut = _f32('mlp_res', t, b1, b2, gamma, shortcut)
    w1t, w2t = _f32('mlp_res', _out_major(w1), _out_major(w2))
    hidden = torch.empty((B * HW, HID), dtype=torch.float32, device=t.device)
    out = torch.empty((B, HW, CO), dtype=torch.float32, device=t.device)
    _launch('mlp_res', build.library().trunk_mlp_res, t.data_ptr(), B * HW,
            C, HID, CO, w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
            b2.data_ptr(), gamma.data_ptr(), shortcut.data_ptr(),
            hidden.data_ptr(), out.data_ptr(), device=t.device)
    mlp_res.launches += 1
    return out


def _dense_launch(x, w, b):
    B, HW, C = x.shape
    if w.shape[0] != C:
        raise ValueError('dense: bad weight shape')
    x, b = _f32('dense', x, b)
    wt, = _f32('dense', _out_major(w))
    CO = wt.shape[0]
    out = torch.empty((B, HW, CO), dtype=torch.float32, device=x.device)
    _launch('dense', build.library().trunk_dense, x.data_ptr(), B * HW, C,
            CO, wt.data_ptr(), b.data_ptr(), out.data_ptr(), device=x.device)
    return out


def dense(x, w, b):
    """x (B, HW, C) @ w (C, CO) + b: the 1x1 conv of patch_upsample."""
    if not _on_card('dense', x, w, b):
        return dense_plain(x, w, b)
    out = _dense_launch(x, w, b)
    dense.launches += 1
    return out


def _prior_head_launch(entry, x, w, b, table, act):
    B, HW, C = x.shape
    if w.shape[0] != C or w.shape[1] % 2:
        raise ValueError('prior_head: bad weight shape')
    Z = w.shape[1] // 2
    x, b, table = _f32('prior_head', x, b, table)
    wt, = _f32('prior_head', _out_major(w))
    pm = torch.empty((B, HW, Z), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, HW, Z), dtype=torch.int32, device=x.device)
    _launch('prior_head', entry, x.data_ptr(), B * HW, C, Z, wt.data_ptr(),
            b.data_ptr(), table.data_ptr(), table.numel(), int(bool(act)),
            pm.data_ptr(), idx.data_ptr(), device=x.device)
    return pm, idx


def prior_head(x, w, b, table, act=False):
    """x (B, HW, C) -> pm (B, HW, Z) float32, scale indexes (B, HW, Z)
    int32: 1x1 conv (w (C, 2Z)) -> softplus(plogv + 2.3) - 2.3 -> exp ->
    max(., table[0]) -> #(table < scale), capped at the last index. act
    applies a GELU to x first (the QRes prior's pre-activated conv)."""
    if not _on_card('prior_head', x, w, b, table):
        return prior_head_plain(x, w, b, table, act)
    out = _prior_head_launch(build.library().trunk_prior_head, x, w, b,
                             table, act)
    prior_head.launches += 1
    return out


def prior_head_oldcore(x, w, b, table, act=False):
    """prior_head on the old product core (gemm_kernel, the table read
    through the read-only cache): the bitwise oracle of prior_head's tiled
    kernel in chip_smoke.py and the card tests; not on the main path, and
    not counted in prior_head.launches."""
    if not _on_card('prior_head', x, w, b, table):
        return prior_head_plain(x, w, b, table, act)
    return _prior_head_launch(build.library().trunk_prior_head_oldcore, x, w,
                              b, table, act)


def _fuse_zproj_launch(entry, feature, syms, pm, w, b):
    B, HW, C = feature.shape
    Z = w.shape[0]
    if (syms.dtype != torch.int32 or syms.shape != (B, HW, Z)
            or pm.shape != (B, HW, Z) or w.shape[1] != C):
        raise ValueError('fuse_zproj: bad symbols/prior/weight shapes')
    feature, pm, b = _f32('fuse_zproj', feature, pm, b)
    wt, = _f32('fuse_zproj', _out_major(w))
    syms = syms.contiguous()
    out = torch.empty_like(feature)
    _launch('fuse_zproj', entry, feature.data_ptr(), syms.data_ptr(),
            pm.data_ptr(), B * HW, Z, C, wt.data_ptr(), b.data_ptr(),
            out.data_ptr(), device=feature.device)
    return out


def fuse_zproj(feature, syms, pm, w, b):
    """feature (B, HW, C) + (syms + pm) @ w + b; syms int32 (B, HW, Z): the
    junction where the decoded integers re-enter the trunk."""
    if not _on_card('fuse_zproj', feature, syms, pm, w, b):
        return fuse_zproj_plain(feature, syms, pm, w, b)
    out = _fuse_zproj_launch(build.library().trunk_fuse_zproj, feature, syms,
                             pm, w, b)
    fuse_zproj.launches += 1
    return out


def fuse_zproj_oldcore(feature, syms, pm, w, b):
    """fuse_zproj on the old product core (gemm_kernel, the conversion in
    its A-tile load): the bitwise oracle of fuse_zproj's tiled kernel in
    chip_smoke.py and the card tests; not on the main path, and not counted
    in fuse_zproj.launches."""
    if not _on_card('fuse_zproj', feature, syms, pm, w, b):
        return fuse_zproj_plain(feature, syms, pm, w, b)
    return _fuse_zproj_launch(build.library().trunk_fuse_zproj_oldcore,
                              feature, syms, pm, w, b)


def _finish_launch(x):
    x, = _f32('finish_image', x)
    out = torch.empty_like(x)
    _launch('finish_image', build.library().trunk_finish_image, x.data_ptr(),
            x.numel(), out.data_ptr(), device=x.device)
    return out.to(torch.float16)


def finish_image(x):
    """x (B, H, W, 3) float32 -> clip(x, -1, 1) * 0.5 + 0.5 as float16. The
    cast is one IEEE rounding of the kernel's exact float32 output. On no
    main path since the tail's last conv runs as upsample_finish; with
    dense before it, upsample_finish's oracle (upsample_finish_chain)."""
    if not _on_card('finish_image', x):
        return finish_image_plain(x).to(torch.float16)
    out = _finish_launch(x)
    finish_image.launches += 1
    return out


def _shuffle_args(name, x, C, N, rate):
    """-> (x contiguous float32, B, H, W, r), checking that the conv
    maps C channels to N = k * 3 * r * r outputs."""
    B, H, W, Cx = x.shape
    r = int(rate)
    if r < 1 or Cx != C or N != 3 * r * r:
        raise ValueError(f'{name}: bad weight shape or rate')
    x, = _f32(name, x)
    return x, B, H, W, r


def _upsample_finish_launch(entry, x, w, b, rate):
    x, B, H, W, r = _shuffle_args('upsample_finish', x, w.shape[0],
                                  w.shape[1], rate)
    b, = _f32('upsample_finish', b)
    wt, = _f32('upsample_finish', _out_major(w))
    out = torch.empty((B, r * H, r * W, 3), dtype=torch.float16,
                      device=x.device)
    _launch('upsample_finish', entry, x.data_ptr(), B * H * W, W,
            x.shape[-1], r, wt.data_ptr(), b.data_ptr(), out.data_ptr(),
            device=x.device)
    return out


def upsample_finish(x, w, b, rate):
    """The synthesis tail's last patch_upsample and the pixel finish in one
    launch: x (B, H, W, C) float32, w (C, 3 * rate**2), b -> clip(pixel
    shuffle(x @ w + b), -1, 1) * 0.5 + 0.5 as (B, rate*H, rate*W, 3)
    float16, contiguous; bitwise upsample_finish_chain (dense,
    pixel_shuffle_nhwc, finish_image) on the card."""
    if not _on_card('upsample_finish', x, w, b):
        return upsample_finish_plain(x, w, b, rate)
    out = _upsample_finish_launch(build.library().trunk_upsample_finish, x,
                                  w, b, rate)
    upsample_finish.launches += 1
    return out


def upsample_finish_chain(x, w, b, rate):
    """What upsample_finish replaced: dense, pixel_shuffle_nhwc(...)
    .contiguous(), then finish_image's kernel and the float16 cast, four
    device passes; its bitwise oracle on the card (chip_smoke.py, the card
    tests). Not counted."""
    if not _on_card('upsample_finish', x, w, b):
        return upsample_finish_plain(x, w, b, rate)
    B, H, W, C = x.shape
    y = _dense_launch(x.reshape(B, H * W, C), w, b).reshape(B, H, W, -1)
    return _finish_launch(pixel_shuffle_nhwc(y, int(rate)).contiguous())


def _head_operands(w_mean, b_mean, w_scale, b_scale):
    """The two convs' (2G, C) out-major weight (the mean's rows, then the
    scale's) and (2G,) bias, made once per version of the four tensors and
    kept on the mean weight's storage owner (_prepared)."""
    owner = w_mean if w_mean._base is None else w_mean._base
    return _prepared(owner, lambda _: (
        torch.cat([_out_major(w_mean), _out_major(w_scale)]),
        torch.cat([b_mean, b_scale])), w_mean, w_scale, b_mean, b_scale)


def upsample_head(x, w_mean, b_mean, w_scale, b_scale, rate):
    """The lossless head's two patch_upsample convs on one feature in one
    launch: x (B, H, W, C) float32, w_* (C, 3 * rate**2) -> (m, r), each
    pixel_shuffle(x @ w_* + b_*) as (B, rate*H, rate*W, 3) float32,
    contiguous (the layout nll_head reads); bitwise upsample_head_chain on
    the card."""
    if not _on_card('upsample_head', x, w_mean, b_mean, w_scale, b_scale):
        return upsample_head_plain(x, w_mean, b_mean, w_scale, b_scale, rate)
    if w_scale.shape != w_mean.shape or b_mean.shape != b_scale.shape:
        raise ValueError('upsample_head: the two convs differ in shape')
    x, B, H, W, r = _shuffle_args('upsample_head', x, w_mean.shape[0],
                                  w_mean.shape[1], rate)
    wt, bias = _f32('upsample_head',
                    *_head_operands(w_mean, b_mean, w_scale, b_scale))
    m, s = (torch.empty((B, r * H, r * W, 3), dtype=torch.float32,
                        device=x.device) for _ in range(2))
    _launch('upsample_head', build.library().trunk_upsample_head,
            x.data_ptr(), B * H * W, W, x.shape[-1], r, wt.data_ptr(),
            bias.data_ptr(), m.data_ptr(), s.data_ptr(), device=x.device)
    upsample_head.launches += 1
    return m, s


def upsample_head_chain(x, w_mean, b_mean, w_scale, b_scale, rate):
    """What upsample_head replaced: per conv dense, then
    pixel_shuffle_nhwc(...).contiguous(), four device passes; its bitwise
    oracle on the card. Not counted."""
    if not _on_card('upsample_head', x, w_mean, b_mean, w_scale, b_scale):
        return upsample_head_plain(x, w_mean, b_mean, w_scale, b_scale, rate)
    B, H, W, C = x.shape
    return tuple(pixel_shuffle_nhwc(
        _dense_launch(x.reshape(B, H * W, C), w, b).reshape(B, H, W, -1),
        int(rate)).contiguous() for w, b in ((w_mean, b_mean),
                                              (w_scale, b_scale)))


# ---- the QRes-VAE trunk (lvae_tpu/ops/pallas/trunk.py:446-748) -----------

def _dw_ln_affine_launch(entry, x, dwk, dwb, scale, bias, kernel_size):
    B, H, W, C = x.shape
    K = int(kernel_size)
    if dwk.shape != (K, K, C) or scale.shape != (C,) or K % 2 != 1:
        raise ValueError('dw_ln_affine: bad weight shapes')
    # the kernel reads (K, K, C) tap-major: free when dwk is contiguous, as
    # convnext_plain's cached weight is
    x, dwk, dwb, scale, bias = _f32('dw_ln_affine', x, dwk, dwb, scale, bias)
    out = torch.empty_like(x)
    _launch('dw_ln_affine', entry, x.data_ptr(), B, H, W, C, K,
            dwk.data_ptr(), dwb.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), device=x.device)
    return out


def dw_ln_affine(x, dwk, dwb, scale, bias, kernel_size):
    """K x K depthwise conv ('same', zero padding) + bias -> LayerNorm over C
    (eps 1e-6) -> y * scale + bias, the plain ConvNeXt block's norm. x (B, H,
    W, C), C <= 512; dwk (K, K, C), K odd; scale, bias (C,)."""
    if not _on_card('dw_ln_affine', x, dwk, dwb, scale, bias):
        return dw_ln_affine_plain(x, dwk, dwb, scale, bias, kernel_size)
    out = _dw_ln_affine_launch(build.library().trunk_dw_ln_affine, x, dwk,
                               dwb, scale, bias, kernel_size)
    dw_ln_affine.launches += 1
    return out


def dw_ln_affine_warp(x, dwk, dwb, scale, bias, kernel_size):
    """dw_ln_affine on the warp-per-pixel kernel: the halo-tile kernel's
    bitwise oracle (as dw_ln_mod_warp); not on the main path, not counted."""
    if not _on_card('dw_ln_affine', x, dwk, dwb, scale, bias):
        return dw_ln_affine_plain(x, dwk, dwb, scale, bias, kernel_size)
    return _dw_ln_affine_launch(build.library().trunk_dw_ln_affine_warp, x,
                                dwk, dwb, scale, bias, kernel_size)


def _dense_act_launch(entry, x, w, b, act, prepass=None):
    """prepass: whether act runs the GELU pass into a scratch (True) or on
    the staged tile (False); None for the old core's entry point, which
    takes no scratch."""
    B, HW, C = x.shape
    if w.shape[0] != C:
        raise ValueError('dense_act: bad weight shape')
    x, b = _f32('dense_act', x, b)
    wt, = _f32('dense_act', _out_major(w))
    CO = wt.shape[0]
    out = torch.empty((B, HW, CO), dtype=torch.float32, device=x.device)
    scratch = ()
    if prepass is not None:
        # gelu(x), once per element, for the product to read
        s = torch.empty_like(x) if act and prepass else None
        scratch = (None if s is None else s.data_ptr(),)
    _launch('dense_act', entry, x.data_ptr(), B * HW, C, CO, wt.data_ptr(),
            b.data_ptr(), int(bool(act)), *scratch, out.data_ptr(),
            device=x.device)
    return out


def dense_act(x, w, b, act=True):
    """x (B, HW, C) -> (gelu(x) or x) @ w (C, CO) + b. One count a call;
    with act the call launches a GELU pass and then the product."""
    if not _on_card('dense_act', x, w, b):
        return dense_act_plain(x, w, b, act)
    out = _dense_act_launch(build.library().trunk_dense_act, x, w, b, act,
                            prepass=True)
    dense_act.launches += 1
    return out


def dense_act_staged(x, w, b, act=True):
    """dense_act in one launch, the GELU applied to the staged A tile in
    shared memory as prior_head's kernel applies it: prior_head's product
    without its index epilogue, and the yardstick of dense_act's pre-pass,
    in chip_smoke.py; not on the main path, not counted."""
    if not _on_card('dense_act', x, w, b):
        return dense_act_plain(x, w, b, act)
    return _dense_act_launch(build.library().trunk_dense_act, x, w, b, act,
                             prepass=False)


def dense_act_oldcore(x, w, b, act=True):
    """dense_act on the old product core (gemm_kernel, the GELU in its
    A-tile load): the bitwise oracle of every product on the tiled core
    (dense, conv_kxk_act on im2col_tapmajor's columns, mlp_res and
    dense_act itself) in chip_smoke.py and the card tests; not on the main
    path, and not counted in dense_act.launches."""
    if not _on_card('dense_act', x, w, b):
        return dense_act_plain(x, w, b, act)
    return _dense_act_launch(build.library().trunk_dense_act_oldcore, x, w,
                             b, act)


def conv_kxk_act(x, wk, b, act=True):
    """'same' K x K conv (zero padding) with an optional GELU on the input:
    x (B, H, W, Ci), wk (K, K, Ci, Co) (the flax layout) -> (B, H, W, Co).
    One count a call; with act the call launches a GELU pass and then the
    product."""
    if not _on_card('conv_kxk_act', x, wk, b):
        return conv_kxk_act_plain(x, wk, b, act)
    B, H, W, Ci = x.shape
    K, Co = wk.shape[0], wk.shape[-1]
    if wk.shape != (K, K, Ci, Co) or K % 2 != 1:
        raise ValueError('conv_kxk_act: bad weight shape')
    x, b = _f32('conv_kxk_act', x, b)
    # (Co, K*K*Ci), k = (di*K + dj)*Ci + ci: the kernel's tap-major depth;
    # free when wk is a view of a contiguous (Co, K, K, Ci), as _kxk_w's is
    wt, = _f32('conv_kxk_act', wk.permute(3, 0, 1, 2).reshape(Co, -1))
    out = torch.empty((B, H, W, Co), dtype=torch.float32, device=x.device)
    # gelu(x), once per element, for the product to read (act only)
    scratch = torch.empty_like(x) if act else None
    _launch('conv_kxk_act', build.library().trunk_conv_kxk_act, x.data_ptr(),
            B, H, W, Ci, K, Co, wt.data_ptr(), b.data_ptr(), int(bool(act)),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            device=x.device)
    conv_kxk_act.launches += 1
    return out


def im2col_tapmajor(x, K):
    """x (B, H, W, Ci) -> (B, H*W, K*K*Ci), column k = (di*K + dj)*Ci + ci
    holding x[b, h + di - p, w + dj - p, ci] (0 outside the image), the
    depth order of conv_kxk_act's kernel. Pure data movement (pad, slices,
    stack), so value-exact: dense_act_oldcore on it is the conv on the old
    product core (a bitwise oracle for the kernel; not on the main
    path)."""
    B, H, W, Ci = x.shape
    p = (K - 1) // 2
    xp = F.pad(x, (0, 0, p, p, p, p))
    taps = torch.stack([xp[:, di:di + H, dj:dj + W, :]
                        for di in range(K) for dj in range(K)], dim=3)
    return taps.reshape(B, H * W, K * K * Ci)


def _zadd_dense_launch(entry, syms, pm, w, b):
    B, HW, Z = syms.shape
    if (syms.dtype != torch.int32 or pm.shape != (B, HW, Z)
            or w.shape[0] != Z):
        raise ValueError('zadd_dense: bad symbols/prior/weight shapes')
    pm, b = _f32('zadd_dense', pm, b)
    wt, = _f32('zadd_dense', _out_major(w))
    syms = syms.contiguous()
    CO = wt.shape[0]
    out = torch.empty((B, HW, CO), dtype=torch.float32, device=pm.device)
    _launch('zadd_dense', entry, syms.data_ptr(), pm.data_ptr(), B * HW, Z,
            CO, wt.data_ptr(), b.data_ptr(), out.data_ptr(), device=pm.device)
    return out


def zadd_dense(syms, pm, w, b):
    """(syms + pm) @ w + b; syms int32 (B, HW, Z), w (Z, CO): the integer
    junction of a kernel-size-1 QRes block."""
    if not _on_card('zadd_dense', syms, pm, w, b):
        return zadd_dense_plain(syms, pm, w, b)
    out = _zadd_dense_launch(build.library().trunk_zadd_dense, syms, pm, w,
                             b)
    zadd_dense.launches += 1
    return out


def zadd_dense_oldcore(syms, pm, w, b):
    """zadd_dense on the old product core (gemm_kernel, the conversion in
    its A-tile load): the bitwise oracle of zadd_dense's tiled kernel in
    chip_smoke.py and the card tests; not on the main path, and not counted
    in zadd_dense.launches."""
    if not _on_card('zadd_dense', syms, pm, w, b):
        return zadd_dense_plain(syms, pm, w, b)
    return _zadd_dense_launch(build.library().trunk_zadd_dense_oldcore, syms,
                              pm, w, b)


def zadd_conv_kxk_plain(syms, pm, wk, b):
    return conv_kxk_act_plain(zadd_plain(syms, pm), wk, b, False)


def zadd_conv_kxk(syms, pm, wk, b):
    """z_proj_0 of a QRes latent block at kernel size >= 3: the 'same' K x K
    conv (zero padding, no GELU) of z = syms + pm, in one launch that never
    writes z. syms int32 and pm (B, H, W, Z); wk (K, K, Z, Co) (the flax
    layout) -> (B, H, W, Co). Bitwise conv_kxk_act(zadd(syms, pm), wk, b,
    False) on the card."""
    if not _on_card('zadd_conv_kxk', syms, pm, wk, b):
        return zadd_conv_kxk_plain(syms, pm, wk, b)
    B, H, W, Z = syms.shape
    K, Co = wk.shape[0], wk.shape[-1]
    if (syms.dtype != torch.int32 or pm.shape != syms.shape
            or wk.shape != (K, K, Z, Co) or K % 2 != 1):
        raise ValueError('zadd_conv_kxk: bad symbols/prior/weight shapes')
    pm, b = _f32('zadd_conv_kxk', pm, b)
    # the tap-major (Co, K*K*Z) of conv_kxk_act; free for _kxk_w's view
    wt, = _f32('zadd_conv_kxk', wk.permute(3, 0, 1, 2).reshape(Co, -1))
    syms = syms.contiguous()
    out = torch.empty((B, H, W, Co), dtype=torch.float32, device=pm.device)
    _launch('zadd_conv_kxk', build.library().trunk_zadd_conv_kxk,
            syms.data_ptr(), pm.data_ptr(), B, H, W, Z, K, Co, wt.data_ptr(),
            b.data_ptr(), out.data_ptr(), device=pm.device)
    zadd_conv_kxk.launches += 1
    return out


def zadd(syms, pm):
    """syms (int32) + pm as float32, any shape: with conv_kxk_act(act=False)
    after it, the bitwise oracle of zadd_conv_kxk (chip_smoke.py, the card
    tests); off the main path, which never writes z."""
    if not _on_card('zadd', syms, pm):
        return zadd_plain(syms, pm)
    if syms.dtype != torch.int32 or syms.shape != pm.shape:
        raise ValueError('zadd: bad symbols/prior shapes')
    pm, = _f32('zadd', pm)
    syms = syms.contiguous()
    out = torch.empty_like(pm)
    _launch('zadd', build.library().trunk_zadd, syms.data_ptr(),
            pm.data_ptr(), pm.numel(), out.data_ptr(), device=pm.device)
    zadd.launches += 1
    return out


def _res_dense_act_launch(entry, f, t, w, b, prepass=None):
    """prepass: whether the GELU runs as a pass into a scratch (True) or on
    the staged tile (False); None for the old core's entry point, which
    takes no scratch."""
    B, HW, C = f.shape
    Ci = t.shape[2]
    if t.shape != (B, HW, Ci) or w.shape != (Ci, C):
        raise ValueError('res_dense_act: bad input/weight shapes')
    f, t, b = _f32('res_dense_act', f, t, b)
    wt, = _f32('res_dense_act', _out_major(w))
    out = torch.empty_like(f)
    scratch = ()
    if prepass is not None:
        # gelu(t), once per element, for the product to read
        s = torch.empty_like(t) if prepass else None
        scratch = (None if s is None else s.data_ptr(),)
    _launch('res_dense_act', entry, f.data_ptr(), t.data_ptr(), B * HW, Ci,
            C, wt.data_ptr(), b.data_ptr(), *scratch, out.data_ptr(),
            device=f.device)
    return out


def res_dense_act(f, t, w, b):
    """f + gelu(t) @ w + b, added as (f + product) + b; f (B, HW, C), t
    (B, HW, Ci), w (Ci, C): the z_proj_1 residual join. One launch, the
    GELU on the staged tile (ahead of the pre-pass design on the card;
    PERF.md)."""
    if not _on_card('res_dense_act', f, t, w, b):
        return res_dense_act_plain(f, t, w, b)
    out = _res_dense_act_launch(build.library().trunk_res_dense_act, f, t, w,
                                b, prepass=False)
    res_dense_act.launches += 1
    return out


def res_dense_act_prepass(f, t, w, b):
    """res_dense_act with its GELU as a pass into a scratch first, then the
    product (two launches): the design the main path does not take, timed
    and checked beside it in chip_smoke.py; not counted."""
    if not _on_card('res_dense_act', f, t, w, b):
        return res_dense_act_plain(f, t, w, b)
    return _res_dense_act_launch(build.library().trunk_res_dense_act, f, t,
                                 w, b, prepass=True)


def res_dense_act_oldcore(f, t, w, b):
    """res_dense_act on the old product core (gemm_kernel, the GELU in its
    A-tile load): the bitwise oracle of res_dense_act's tiled kernel in
    chip_smoke.py and the card tests; not on the main path, not counted."""
    if not _on_card('res_dense_act', f, t, w, b):
        return res_dense_act_plain(f, t, w, b)
    return _res_dense_act_launch(build.library().trunk_res_dense_act_oldcore,
                                 f, t, w, b)


# ---- the lossless pixel head (lvae_tpu/ops/pallas/trunk.py:740-822) -------

def require_nondecreasing(table, name='scale table'):
    """Raise ValueError unless `table` (a 1-D host array or CPU tensor) is
    non-decreasing and free of NaN: the contract of nll_head's search. Call
    it once where a table is made; the wrapper does not check it per call,
    which would wait for the card."""
    t = np.asarray(table, dtype=np.float64).ravel()
    if t.size < 1 or np.isnan(t).any() or not (t[1:] >= t[:-1]).all():
        raise ValueError(f'{name}: not a non-decreasing table without NaN')


def _nll_head_launch(entry, p_mean, p_scale_raw, table, bin_size):
    if p_scale_raw.shape != p_mean.shape or table.ndim != 1:
        raise ValueError('nll_head: bad scale/table shapes')
    p_mean, p_scale_raw, table = _f32('nll_head', p_mean, p_scale_raw, table)
    pm = torch.empty_like(p_mean)
    idx = torch.empty(p_mean.shape, dtype=torch.int32, device=p_mean.device)
    _launch('nll_head', entry, p_mean.data_ptr(), p_scale_raw.data_ptr(),
            p_mean.numel(), table.data_ptr(), table.numel(), bin_size,
            math.log(bin_size), pm.data_ptr(), idx.data_ptr(),
            device=p_mean.device)
    return pm, idx


def nll_head(p_mean, p_scale_raw, table, bin_size):
    """The head's raw 1x1-conv outputs p_mean, p_scale_raw (B, H, W, 3) ->
    (pm float32 in bin units, scale indexes int32), each (B, H, W, 3):
    logscale softplus(r + 16) - 16, the mean rounded to the 255-level pixel
    grid (round(m * 127.5 + 127.5) / 127.5 - 1) / bin_size, the index
    #(table < max(exp(logscale - log bin_size), table[0])), capped at the
    last entry. Every step one float32 operation (csrc/trunk.cu): these
    chains decide on which grid value each pixel lands. The kernel finds
    the index by a binary search, so `table` must be non-decreasing
    (require_nondecreasing, checked once where the table is made, not
    here)."""
    if not _on_card('nll_head', p_mean, p_scale_raw, table):
        return nll_head_plain(p_mean, p_scale_raw, table, bin_size)
    out = _nll_head_launch(build.library().trunk_nll_head, p_mean,
                           p_scale_raw, table, bin_size)
    nll_head.launches += 1
    return out


def nll_head_linear(p_mean, p_scale_raw, table, bin_size):
    """nll_head on the design it replaced (every element compares against
    all S entries; any table order): the bitwise oracle of nll_head's
    kernel in chip_smoke.py and the card tests; not on the main path, and
    not counted in nll_head.launches."""
    if not _on_card('nll_head', p_mean, p_scale_raw, table):
        return nll_head_plain(p_mean, p_scale_raw, table, bin_size)
    return _nll_head_launch(build.library().trunk_nll_head_linear, p_mean,
                            p_scale_raw, table, bin_size)


def nll_recon(syms, pm, bin_size):
    """The exact lossless pixels: round(255 * (clip((syms + pm) * bin_size,
    -1, 1) * 0.5 + 0.5)) as integer-valued float32, (B, H, W, 3); the caller
    casts them to uint8."""
    if not _on_card('nll_recon', syms, pm):
        return nll_recon_plain(syms, pm, bin_size)
    if syms.dtype != torch.int32 or syms.shape != pm.shape:
        raise ValueError('nll_recon: bad symbols/mean shapes')
    pm, = _f32('nll_recon', pm)
    syms = syms.contiguous()
    out = torch.empty_like(pm)
    _launch('nll_recon', build.library().trunk_nll_recon, syms.data_ptr(),
            pm.data_ptr(), pm.numel(), bin_size, out.data_ptr(),
            device=pm.device)
    nll_recon.launches += 1
    return out


KERNELS = (emb_mlp, dw_ln_mod, mlp_res, dense, prior_head, fuse_zproj,
           finish_image, upsample_finish, upsample_head, dw_ln_affine,
           dense_act, conv_kxk_act, zadd_dense, zadd, zadd_conv_kxk,
           res_dense_act, nll_head, nll_recon)
PLAIN = {emb_mlp: emb_mlp_plain, dw_ln_mod: dw_ln_mod_plain,
         mlp_res: mlp_res_plain, dense: dense_plain,
         prior_head: prior_head_plain, fuse_zproj: fuse_zproj_plain,
         finish_image: lambda x: finish_image_plain(x).to(torch.float16),
         upsample_finish: upsample_finish_plain,
         upsample_head: upsample_head_plain,
         dw_ln_affine: dw_ln_affine_plain, dense_act: dense_act_plain,
         conv_kxk_act: conv_kxk_act_plain, zadd_dense: zadd_dense_plain,
         zadd: zadd_plain, zadd_conv_kxk: zadd_conv_kxk_plain,
         res_dense_act: res_dense_act_plain,
         nll_head: nll_head_plain, nll_recon: nll_recon_plain}
for _k in KERNELS:
    _k.launches = 0


# ---------------------------------------------------------------------------
# module adapters (lvae_tpu/ops/pallas/trunk.py:407-432, 493, 690, 720): the
# port's nn.Module weights -> kernel calls; the weight views cost no copy,
# and the two layouts that need one are made once per weight (_prepared)
# ---------------------------------------------------------------------------

def _prepared(param, make, *also):
    """make(param) kept on the parameter until it, or a tensor of `also`
    that the layout reads too, changes in place (an in-place op or
    load_state_dict bumps its version) or its storage moves (.to()). A
    write through `param.data` bypasses the version counter and is not
    seen."""
    key = (make.__code__,) + tuple((t._version, t.data_ptr())
                                   for t in (param,) + also)
    hit = getattr(param, '_trunk_layout', None)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = (key, make(param.detach()))
        param._trunk_layout = hit
    return hit[1]


def convnext_adaln(x, block, gemb):
    """ConvNeXtBlockAdaLN (models/common.py) on an NHWC feature through
    dw_ln_mod + mlp_res; gemb = gelu(emb) (B, E)."""
    B, H, W, C = x.shape
    K = block.kernel_size
    dwk = block.conv_dw.weight.reshape(C, K, K).permute(1, 2, 0)
    t = dw_ln_mod(x, dwk, block.conv_dw.bias,
                  block.embedding_layer.weight.t(),
                  block.embedding_layer.bias, gemb, K)
    mlp = block.mlp
    y = mlp_res(t.reshape(B, H * W, C), mlp.fc1.weight.t(), mlp.fc1.bias,
                mlp.fc2.weight.t(), mlp.fc2.bias, block.gamma,
                x.reshape(B, H * W, C))
    return y.reshape(B, H, W, C)


def conv1x1(x, conv):
    """1x1 nn.Conv2d on an NHWC feature through the dense kernel."""
    B, H, W, C = x.shape
    w = conv.weight.reshape(conv.out_channels, C).t()
    y = dense(x.reshape(B, H * W, C), w, conv.bias)
    return y.reshape(B, H, W, w.shape[1])


# the adapters pass every argument by position, as chip_smoke.py records
# and replays the wrappers' calls

def patch_upsample_finish(x, up):
    """The synthesis tail's last patch_upsample (models/common.py, to 3
    channels) and the pixel finish on an NHWC feature through
    upsample_finish -> (B, rH, rW, 3) float16."""
    return upsample_finish(x, _dense_w(up.conv), up.conv.bias, up.rate)


def head_upsample(x, conv_mean, conv_scale):
    """The lossless head's two patch_upsample convs (to 3 channels each,
    one rate) on an NHWC feature through upsample_head -> (m, r), each
    (B, rH, rW, 3)."""
    return upsample_head(x, _dense_w(conv_mean.conv), conv_mean.conv.bias,
                         _dense_w(conv_scale.conv), conv_scale.conv.bias,
                         conv_mean.rate)

def _dense_w(conv):
    """1x1 nn.Conv2d weight (Co, Ci, 1, 1) -> a (Ci, Co) view."""
    return conv.weight.reshape(conv.out_channels, -1).t()


def _kxk_w(conv):
    """K x K nn.Conv2d weight (Co, Ci, K, K) -> (K, K, Ci, Co), the flax
    layout conv_kxk_act takes, as a view of a contiguous (Co, K, K, Ci): the
    kernel's tap-major operand without a copy at each call."""
    return _prepared(conv.weight,
                     lambda w: w.permute(0, 2, 3, 1).contiguous()
                     ).permute(1, 2, 3, 0)


def _dw_w(block):
    """Depthwise nn.Conv2d weight (C, 1, K, K) -> contiguous (K, K, C), the
    tap-major layout dw_ln_affine's kernel reads."""
    C, K = block.conv_dw.out_channels, block.kernel_size
    return _prepared(block.conv_dw.weight,
                     lambda w: w.reshape(C, K, K).permute(1, 2, 0).contiguous())


def convnext_plain(x, block):
    """MyConvNeXtBlock (models/common.py) on an NHWC feature through
    dw_ln_affine + mlp_res."""
    B, H, W, C = x.shape
    t = dw_ln_affine(x, _dw_w(block), block.conv_dw.bias, block.norm.weight,
                     block.norm.bias, block.kernel_size)
    mlp = block.mlp
    y = mlp_res(t.reshape(B, H * W, C), mlp.fc1.weight.t(), mlp.fc1.bias,
                mlp.fc2.weight.t(), mlp.fc2.bias, block.gamma,
                x.reshape(B, H * W, C))
    return y.reshape(B, H, W, C)


def qres_prior_head(f_mid, vd, use_3x3, table):
    """The QRes prior, a VDBlock with pre-activation GELUs and no residual
    (models/common.py), then the scale indexes: f_mid (B, H, W, C) -> (pm,
    indexes int32), each (B, H, W, Z)."""
    B, H, W, C = f_mid.shape
    hid = vd.c1.out_channels
    t = dense_act(f_mid.reshape(B, H * W, C), _dense_w(vd.c1), vd.c1.bias)
    if use_3x3:
        t = conv_kxk_act(t.reshape(B, H, W, hid), _kxk_w(vd.c2), vd.c2.bias)
        t = conv_kxk_act(t, _kxk_w(vd.c3), vd.c3.bias).reshape(B, H * W, hid)
    else:
        t = dense_act(t, _dense_w(vd.c2), vd.c2.bias)
        t = dense_act(t, _dense_w(vd.c3), vd.c3.bias)
    Z = vd.c4.out_channels // 2
    pm, idx = prior_head(t, _dense_w(vd.c4), vd.c4.bias, table, True)
    return pm.reshape(B, H, W, Z), idx.reshape(B, H, W, Z)


def qres_fuse(feature, syms, pm, blk):
    """QLatentBlock.fuse_stage (models/qresvae/model.py): z = syms + pm ->
    z_proj_0 (3x3 or 1x1) -> GELU -> z_proj_1 -> + feature -> resnet_end;
    feature (B, H, W, C), syms int32 and pm (B, H, W, Z)."""
    B, H, W, C = feature.shape
    Z = syms.shape[-1]
    s2, pm2 = syms.reshape(B, H * W, Z), pm.reshape(B, H * W, Z)
    z0 = blk.z_proj_0
    if blk.kernel_size >= 3:            # the 3x3 conv, no GELU, z unwritten
        t = zadd_conv_kxk(syms, pm, _kxk_w(z0), z0.bias)
        t = t.reshape(B, H * W, z0.out_channels)
    else:
        t = zadd_dense(s2, pm2, _dense_w(z0), z0.bias)
    o = res_dense_act(feature.reshape(B, H * W, C), t,
                      _dense_w(blk.z_proj_1), blk.z_proj_1.bias)
    return convnext_plain(o.reshape(B, H, W, C), blk.resnet_end)
