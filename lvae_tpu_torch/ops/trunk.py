"""Portable trunk kernels: every float between the stream's integer
junctions, computed by hand-written CUDA kernels whose results do not depend
on the process, the batch size or any library's algorithm choice.

Counterpart of ``lvae_tpu/ops/pallas/trunk.py`` (rows 5-11 of the kernel
table in PERF.md). A rANS stream desyncs when the decoder's recomputed prior
floats differ from the encoder's by one scale-index flip, so a stream that is
to decode in another process (a file) must see bitwise the same trunk floats
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

def emb_mlp_plain(lmb, freqs, w0, b0, w1, b1, sin_period):
    scale = float(sin_period) / math.log(8192.0)
    args = (torch.log(lmb.reshape(-1, 1).float()) * scale) * freqs
    x = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    x = _gelu(x @ w0 + b0)
    emb = x @ w1 + b1
    return emb, _gelu(emb)


def dw_ln_mod_plain(x, dwk, dwb, ew, eb, gemb, kernel_size):
    B, H, W, C = x.shape
    K = kernel_size
    p = (K - 1) // 2
    xp = F.pad(x, (0, 0, p, p, p, p))
    y = torch.zeros_like(x) + dwb
    for di in range(K):
        for dj in range(K):
            y = y + xp[:, di:di + H, dj:dj + W, :] * dwk[di, dj]
    mu = y.mean(-1, keepdim=True)
    var = torch.square(y - mu).mean(-1, keepdim=True)
    y = (y - mu) * (1.0 / torch.sqrt(var + 1e-6))
    e = gemb @ ew + eb
    shift, scale = e[:, None, None, :C], e[:, None, None, C:]
    return y * (1.0 + scale) + shift


def mlp_res_plain(t, w1, b1, w2, b2, gamma, shortcut):
    o = _gelu(t @ w1 + b1) @ w2 + b2
    return shortcut + o * gamma


def dense_plain(x, w, b):
    return x @ w + b


def prior_scales_plain(x, w, b, table, act=False):
    """-> (pm, the clamped scales, scale indexes): prior_head's plain version
    with the scales it compares against the table."""
    Z = w.shape[1] // 2
    p = (_gelu(x) if act else x) @ w + b
    pm, plogv = p[..., :Z], p[..., Z:]
    pv = torch.exp(_softplus(plogv + 2.3) - 2.3)
    pv = torch.maximum(pv, table[0])
    idx = (table < pv[..., None]).sum(-1, dtype=torch.int32)
    return pm, pv, torch.clamp(idx, max=table.shape[0] - 1)


def prior_head_plain(x, w, b, table, act=False):
    pm, _, idx = prior_scales_plain(x, w, b, table, act)
    return pm, idx


def fuse_zproj_plain(feature, syms, pm, w, b):
    return feature + ((syms.to(torch.float32) + pm) @ w + b)


def finish_image_plain(x):
    return torch.clamp(x, -1.0, 1.0) * 0.5 + 0.5


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


def emb_mlp(lmb, freqs, w0, b0, w1, b1, sin_period):
    """lmb (B,) -> (emb (B, E), gelu(emb) (B, E)): log-lambda sinusoid ->
    Linear -> GELU -> Linear. freqs (1, E0/2); w0 (E0, E); w1 (E, E)."""
    if not _on_card('emb_mlp', lmb, freqs, w0, b0, w1, b1):
        return emb_mlp_plain(lmb, freqs, w0, b0, w1, b1, sin_period)
    B = lmb.numel()
    E0, E = w0.shape
    if freqs.numel() * 2 != E0 or w1.shape != (E, E):
        raise ValueError('emb_mlp: bad freqs/w0/w1 shapes')
    lmb, freqs, b0, b1 = _f32('emb_mlp', lmb, freqs, b0, b1)
    w0t, w1t = _f32('emb_mlp', _out_major(w0), _out_major(w1))
    emb = torch.empty((B, E), dtype=torch.float32, device=lmb.device)
    gemb = torch.empty_like(emb)
    scale = float(sin_period) / math.log(8192.0)
    _launch('emb_mlp', build.library().trunk_emb_mlp, lmb.data_ptr(), B,
            freqs.data_ptr(), w0t.data_ptr(), b0.data_ptr(), w1t.data_ptr(),
            b1.data_ptr(), E0, E, scale, emb.data_ptr(), gemb.data_ptr(),
            device=lmb.device)
    emb_mlp.launches += 1
    return emb, gemb


def dw_ln_mod(x, dwk, dwb, ew, eb, gemb, kernel_size):
    """K x K depthwise conv ('same', zero padding) + bias -> LayerNorm over C
    (eps 1e-6, no affine) -> y * (1 + scale) + shift, (shift, scale) =
    gemb @ ew + eb. x (B, H, W, C); dwk (K, K, C); ew (E, 2C); gemb (B, E)."""
    if not _on_card('dw_ln_mod', x, dwk, dwb, ew, eb, gemb):
        return dw_ln_mod_plain(x, dwk, dwb, ew, eb, gemb, kernel_size)
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
    _launch('dw_ln_mod', build.library().trunk_dw_ln_mod, x.data_ptr(), B, H,
            W, C, K, dwk_c.data_ptr(), dwb.data_ptr(), ewt.data_ptr(),
            eb.data_ptr(), gemb.data_ptr(), E, scratch.data_ptr(),
            out.data_ptr(), device=x.device)
    dw_ln_mod.launches += 1
    return out


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


def dense(x, w, b):
    """x (B, HW, C) @ w (C, CO) + b: the 1x1 conv of patch_upsample."""
    if not _on_card('dense', x, w, b):
        return dense_plain(x, w, b)
    B, HW, C = x.shape
    if w.shape[0] != C:
        raise ValueError('dense: bad weight shape')
    x, b = _f32('dense', x, b)
    wt, = _f32('dense', _out_major(w))
    CO = wt.shape[0]
    out = torch.empty((B, HW, CO), dtype=torch.float32, device=x.device)
    _launch('dense', build.library().trunk_dense, x.data_ptr(), B * HW, C,
            CO, wt.data_ptr(), b.data_ptr(), out.data_ptr(), device=x.device)
    dense.launches += 1
    return out


def prior_head(x, w, b, table, act=False):
    """x (B, HW, C) -> pm (B, HW, Z) float32, scale indexes (B, HW, Z)
    int32: 1x1 conv (w (C, 2Z)) -> softplus(plogv + 2.3) - 2.3 -> exp ->
    max(., table[0]) -> #(table < scale), capped at the last index. act
    applies a GELU to x first (the QRes prior's pre-activated conv)."""
    if not _on_card('prior_head', x, w, b, table):
        return prior_head_plain(x, w, b, table, act)
    B, HW, C = x.shape
    if w.shape[0] != C or w.shape[1] % 2:
        raise ValueError('prior_head: bad weight shape')
    Z = w.shape[1] // 2
    x, b, table = _f32('prior_head', x, b, table)
    wt, = _f32('prior_head', _out_major(w))
    pm = torch.empty((B, HW, Z), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, HW, Z), dtype=torch.int32, device=x.device)
    _launch('prior_head', build.library().trunk_prior_head, x.data_ptr(),
            B * HW, C, Z, wt.data_ptr(), b.data_ptr(), table.data_ptr(),
            table.numel(), int(bool(act)), pm.data_ptr(), idx.data_ptr(),
            device=x.device)
    prior_head.launches += 1
    return pm, idx


def fuse_zproj(feature, syms, pm, w, b):
    """feature (B, HW, C) + (syms + pm) @ w + b; syms int32 (B, HW, Z): the
    junction where the decoded integers re-enter the trunk."""
    if not _on_card('fuse_zproj', feature, syms, pm, w, b):
        return fuse_zproj_plain(feature, syms, pm, w, b)
    B, HW, C = feature.shape
    Z = w.shape[0]
    if (syms.dtype != torch.int32 or syms.shape != (B, HW, Z)
            or pm.shape != (B, HW, Z) or w.shape[1] != C):
        raise ValueError('fuse_zproj: bad symbols/prior/weight shapes')
    feature, pm, b = _f32('fuse_zproj', feature, pm, b)
    wt, = _f32('fuse_zproj', _out_major(w))
    syms = syms.contiguous()
    out = torch.empty_like(feature)
    _launch('fuse_zproj', build.library().trunk_fuse_zproj,
            feature.data_ptr(), syms.data_ptr(), pm.data_ptr(), B * HW, Z, C,
            wt.data_ptr(), b.data_ptr(), out.data_ptr(),
            device=feature.device)
    fuse_zproj.launches += 1
    return out


def finish_image(x):
    """x (B, H, W, 3) float32 -> clip(x, -1, 1) * 0.5 + 0.5 as float16. The
    cast is one IEEE rounding of the kernel's exact float32 output."""
    if not _on_card('finish_image', x):
        return finish_image_plain(x).to(torch.float16)
    x, = _f32('finish_image', x)
    out = torch.empty_like(x)
    _launch('finish_image', build.library().trunk_finish_image, x.data_ptr(),
            x.numel(), out.data_ptr(), device=x.device)
    finish_image.launches += 1
    return out.to(torch.float16)


KERNELS = (emb_mlp, dw_ln_mod, mlp_res, dense, prior_head, fuse_zproj,
           finish_image)
PLAIN = {emb_mlp: emb_mlp_plain, dw_ln_mod: dw_ln_mod_plain,
         mlp_res: mlp_res_plain, dense: dense_plain,
         prior_head: prior_head_plain, fuse_zproj: fuse_zproj_plain,
         finish_image: lambda x: finish_image_plain(x).to(torch.float16)}
for _k in KERNELS:
    _k.launches = 0


# ---------------------------------------------------------------------------
# module adapters (lvae_tpu/ops/pallas/trunk.py:407-432): the port's
# nn.Module weights -> kernel calls; the weight views cost no copy
# ---------------------------------------------------------------------------

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
