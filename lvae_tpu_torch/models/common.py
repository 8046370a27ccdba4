"""NN building blocks in PyTorch (NCHW), counterparts of
``lvae_tpu/models/common.py``.

Parameter names mirror the flax modules' so that
``models.weights.params_from_flax`` maps every flax leaf onto one entry of
the state dict. Unlike flax, a torch convolution needs its input width, so
the constructors take it explicitly.
"""
import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def apply_block(block, *args, remat=False, **kwargs):
    """block(*args, **kwargs), optionally under gradient rematerialization
    (lvae_tpu/models/common.py:24-44): remat=True drops the block's
    activations after the forward and recomputes them in the backward pass
    (torch.utils.checkpoint, non-reentrant), for ~one more forward of
    operations and O(1) blocks of activation memory.

    The recomputation runs the block on the parameter tensors it saw in the
    forward, under its oneDNN flag: inside torch.func.functional_call (the bf16 training forward's
    casts) those are the casts, which the call has swapped back out by the
    time the backward runs. A block must draw no noise from an explicit
    torch.Generator: checkpoint restores only the global RNG states, so
    callers draw it outside and pass it in."""
    params = dict(block.named_parameters()) if remat else None
    if not params:
        return block(*args, **kwargs)
    # the recomputation picks the forward's convolution kernels
    # (base.cpu_lowp_convs may have switched oneDNN off around it)
    mkldnn = torch.backends.mkldnn.enabled
    return checkpoint(lambda *a, **kw: torch.func.functional_call(
        block, params, a, kw), *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(),
                            mkldnn_enabled(mkldnn)),
        **kwargs)


@contextlib.contextmanager
def mkldnn_enabled(enabled):
    """torch.backends.mkldnn.enabled set to `enabled` for the duration."""
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = enabled
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


def latent_noise(draw, block, feature, generator):
    """draw(like, generator) (entropy_coding.uniform_noise or normal_noise)
    of a latent block's posterior shape (B, zdim, H, W) and dtype, for the
    block's input feature: drawn before the block runs, so that a
    rematerialized block recomputes on the same noise and the generator
    advances once."""
    B, _, H, W = feature.shape
    return draw(feature.new_empty(B, block.zdim, H, W), generator)


def apply_promoted(module, x):
    """module(x) with its floating parameters cast to x's dtype: flax's
    promotion where a float32 input meets bfloat16 parameters (the bf16
    training forward's lambda embedding and lossless head compute in
    float32 on the bf16-rounded weights, as the JAX package's do)."""
    params = dict(module.named_parameters())
    if all(p.dtype == x.dtype for p in params.values()):
        return module(x)
    return torch.func.functional_call(
        module, {k: p.to(x.dtype) for k, p in params.items()}, (x,))


def gelu(x):
    return F.gelu(x)  # exact (erf) form, as the JAX package uses


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus form


def get_conv(in_ch, out_ch, kernel_size, stride, padding):
    return nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                     padding=padding)


def conv_k1s1(in_ch, out_ch):
    return get_conv(in_ch, out_ch, 1, 1, 0)


def conv_k3s1(in_ch, out_ch):
    return get_conv(in_ch, out_ch, 3, 1, 1)


class patch_downsample(nn.Module):
    """Strided conv downsample."""

    def __init__(self, in_ch, out_ch, rate=2):
        super().__init__()
        self.rate = rate
        self.conv = get_conv(in_ch, out_ch, rate, rate, 0)

    def forward(self, x):
        return self.conv(x)


class patch_upsample(nn.Module):
    """1x1 conv + PixelShuffle (the JAX package's pixel_shuffle already
    follows torch's channel order)."""

    def __init__(self, in_ch, out_ch, rate=2):
        super().__init__()
        self.rate = rate
        self.conv = get_conv(in_ch, out_ch * rate ** 2, 1, 1, 0)
        self.shuffle = nn.PixelShuffle(rate)

    def forward(self, x):
        return self.shuffle(self.conv(x))


class deconv(nn.Module):
    """Transposed-conv upsample (lvae_tpu/models/common.py:114-131): the
    output is exactly stride x the input, as the JAX module's padding
    (k - 1 - p, k - 1 - p + s - 1) with p = k // 2 gives. A library call on
    the legacy trunk (no portable kernel: qres17m codes legacy streams
    only). Its weight is torch's (in, out, k, k), the flax kernel spatially
    flipped (models/weights.params_from_flax)."""

    def __init__(self, in_ch, out_ch, kernel_size=5, stride=2):
        super().__init__()
        self.stride = stride
        self.conv = nn.ConvTranspose2d(
            in_ch, out_ch, kernel_size, stride=stride,
            padding=kernel_size // 2, output_padding=stride - 1)

    def forward(self, x):
        return self.conv(x)


class upsample_nearest(nn.Module):
    """Nearest-neighbour upsample."""

    def __init__(self, rate=2):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        return x.repeat_interleave(self.rate, 2).repeat_interleave(self.rate, 3)


class SetKey(nn.Module):
    """Identity marker tagging a feature-tap position in a block list."""

    def __init__(self, key):
        super().__init__()
        self.key = key

    def forward(self, x):
        return x


class CompressionStopFlag(nn.Module):
    """Identity marker: blocks after it only synthesize pixels."""

    def forward(self, x):
        return x


def sinusoidal_embedding(values, dim=256, max_period=64):
    """Sinusoidal embedding of a (B,) vector -> (B, dim)."""
    assert values.ndim == 1 and dim % 2 == 0
    exponents = torch.linspace(0.0, 1.0, dim // 2, device=values.device)
    freqs = torch.pow(float(max_period), -exponents)
    args = values[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class Mlp(nn.Module):
    """2-layer MLP on the last (channel) axis."""

    def __init__(self, in_features, hidden_features, out_features):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class ConvNeXtBlockAdaLN(nn.Module):
    """ConvNeXt block with adaptive LayerNorm conditioning: depthwise conv ->
    LayerNorm (eps 1e-6, no affine) -> y*(1+scale)+shift from the embedding
    -> MLP -> gamma layer scale -> residual."""

    requires_embedding = True

    def __init__(self, dim, embed_dim, out_dim=None, kernel_size=7,
                 mlp_ratio=2, residual=True, ls_init_value=1e-6):
        super().__init__()
        out_dim = out_dim or dim
        self.dim, self.kernel_size, self.residual = dim, kernel_size, residual
        self.conv_dw = nn.Conv2d(dim, dim, kernel_size,
                                 padding=(kernel_size - 1) // 2, groups=dim)
        self.embedding_layer = nn.Linear(embed_dim, 2 * dim)
        self.mlp = Mlp(dim, int(mlp_ratio * dim), out_dim)
        self.gamma = (nn.Parameter(torch.full((out_dim,), ls_init_value))
                      if ls_init_value >= 0 else None)

    def forward(self, x, emb):
        shortcut = x
        x = self.conv_dw(x).permute(0, 2, 3, 1)                   # NHWC
        x = F.layer_norm(x, (self.dim,), eps=1e-6)
        shift, scale = self.embedding_layer(gelu(emb)).chunk(2, dim=-1)
        x = x * (1.0 + scale[:, None, None, :]) + shift[:, None, None, :]
        x = self.mlp(x)
        if self.gamma is not None:
            x = x * self.gamma
        x = x.permute(0, 3, 1, 2)
        return x + shortcut if self.residual else x


# ---- the QRes-VAE blocks (lvae_tpu/models/common.py:291-374) ---------------

class MyConvNeXtBlock(nn.Module):
    """Plain ConvNeXt block: depthwise conv -> LayerNorm (eps 1e-6, with
    affine) -> MLP (mlp_ratio 2) -> gamma layer scale -> residual."""

    def __init__(self, dim, kernel_size=7, mlp_ratio=2, ls_init_value=1e-6):
        super().__init__()
        self.dim, self.kernel_size = dim, kernel_size
        self.conv_dw = nn.Conv2d(dim, dim, kernel_size,
                                 padding=(kernel_size - 1) // 2, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(mlp_ratio * dim), dim)
        self.gamma = nn.Parameter(torch.full((dim,), ls_init_value))

    def forward(self, x):
        y = self.norm(self.conv_dw(x).permute(0, 2, 3, 1))          # NHWC
        y = self.mlp(y) * self.gamma
        return y.permute(0, 3, 1, 2) + x


class MyConvNeXtPatchDown(nn.Module):
    """MyConvNeXtBlock, then a patch downsample to out_ch channels."""

    def __init__(self, dim, out_ch, down_rate=2, kernel_size=7, mlp_ratio=2):
        super().__init__()
        self.block = MyConvNeXtBlock(dim, kernel_size=kernel_size,
                                     mlp_ratio=mlp_ratio)
        self.downsample = patch_downsample(dim, out_ch, rate=down_rate)

    def forward(self, x):
        return self.downsample(self.block(x))


class VDBlock(nn.Module):
    """VDVAE-style bottleneck: four convs (1x1, 3x3 or 1x1 twice, 1x1), each
    after a GELU; residual optional. zero_last zero-initialises the last
    conv's weight (the QRes prior), rescale_last scales its init."""

    def __init__(self, in_ch, hidden_ch, out_ch, residual=True, use_3x3=True,
                 zero_last=False, rescale_last=1.0):
        super().__init__()
        self.residual = residual
        c = conv_k3s1 if use_3x3 else conv_k1s1
        self.c1 = conv_k1s1(in_ch, hidden_ch)
        self.c2 = c(hidden_ch, hidden_ch)
        self.c3 = c(hidden_ch, hidden_ch)
        self.c4 = conv_k1s1(hidden_ch, out_ch)
        self.c4.init_scale = 0.0 if zero_last else rescale_last  # flax_init_

    def forward(self, x):
        xhat = self.c1(gelu(x))
        xhat = self.c2(gelu(xhat))
        xhat = self.c3(gelu(xhat))
        xhat = self.c4(gelu(xhat))
        return x + xhat if self.residual else xhat


def lecun_normal_(weight, generator=None, scale=1.0):
    """flax's default kernel init (lecun_normal: a normal truncated at two
    standard deviations, variance 1 / fan_in) times `scale`, drawn on the
    CPU from `generator` and copied into `weight` (any device)."""
    std = 1.0 / math.sqrt(weight[0].numel()) / .87962566103423978
    w = torch.empty(weight.shape)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    with torch.no_grad():
        weight.copy_(w * scale)


def flax_init_(net, generator=None):
    """Initialise a network of these blocks as the JAX package's flax
    modules initialise theirs: lecun-normal conv, transposed-conv and dense
    kernels (the first two with flax's fan-in, in x k x k), scaled
    by the module's `init_scale` attribute where it has one (a VDBlock's
    zero_last / rescale_last, QRes's z projection), zero biases, unit
    LayerNorm scales; the layer scales keep their constant."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, generator, getattr(m, 'init_scale', 1.0))
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.ConvTranspose2d):
            # flax's (k, k, in, out) kernel: fan_in = k * k * in
            w = torch.empty(m.weight.shape[1:2] + m.weight.shape[0:1]
                            + m.weight.shape[2:])
            lecun_normal_(w, generator)
            with torch.no_grad():
                m.weight.copy_(w.transpose(0, 1))
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
