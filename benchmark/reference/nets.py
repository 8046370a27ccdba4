"""The plain reference of the two codec families, in float32 PyTorch with no
kernel, cache or batching of the program: QARV (Duan et al., "QARV:
Quantization-Aware ResNet VAE for Lossy Image Compression", TPAMI 2023) and
QRes-VAE (Duan et al., "Lossy Image Compression with Quantized Hierarchical
VAEs", WACV 2023, MSE head).

A network is built from the configuration's block list (`enc`, `dec`), so
the same code holds the full models and the tiny ones of the tests;
parameter names follow the flax modules', as the program's do, so one
state dict loads into both.

What the codec computes, written as the papers define it:
  * encode: the encoder's features; per latent block, the prior's mean pm
    and scale, the posterior mean qm, the symbols round(qm - pm), then the
    fuse of z = symbols + pm into the feature; up to the stop marker
  * decode: the same chain on given symbols, then the synthesis tail and
    clamp(x, -1, 1) * 0.5 + 0.5
  * the rate: each symbol's ideal bits, -log2 of its unit bin's mass under
    its prior, the Gaussian of mean pm and the block's scale rounded up to
    the codec's table of scales (log-spaced, `scale_table`: lo, hi, n)
  * the training loss: z = qm + U(-0.5, 0.5) noise, the rate -log P(z)
    of the Gaussian's mass over the pixels, plus lambda * MSE on [-1, 1]
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def gelu(x):
    return F.gelu(x)                       # the exact (erf) form


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride=stride,
                     padding=0 if stride > 1 else (k - 1) // 2)


class Marker(nn.Module):
    """A feature tap ('key') or the encode side's stop ('stop'): no
    parameters, but a place in the block list (parameter names count
    it)."""

    def __init__(self, kind, key=None):
        super().__init__()
        self.kind, self.key = kind, key

    def forward(self, x):
        return x


class Down(nn.Module):
    def __init__(self, cin, cout, rate):
        super().__init__()
        self.conv = conv(cin, cout, rate, stride=rate)

    def forward(self, x):
        return self.conv(x)


class Up(nn.Module):
    """1x1 conv, then pixel shuffle."""

    def __init__(self, cin, cout, rate):
        super().__init__()
        self.rate = rate
        self.conv = conv(cin, cout * rate * rate, 1)

    def forward(self, x):
        return F.pixel_shuffle(self.conv(x), self.rate)


class Mlp(nn.Module):
    def __init__(self, dim, hidden, out):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class AdaLNBlock(nn.Module):
    """ConvNeXt block with adaptive LayerNorm: depthwise conv, LayerNorm
    (eps 1e-6, no affine), x * (1 + scale) + shift from gelu(embedding),
    MLP, layer scale, residual."""

    def __init__(self, dim, embed_dim, k, mlp_ratio):
        super().__init__()
        self.dim = dim
        self.conv_dw = nn.Conv2d(dim, dim, k, padding=(k - 1) // 2,
                                 groups=dim)
        self.embedding_layer = nn.Linear(embed_dim, 2 * dim)
        self.mlp = Mlp(dim, int(mlp_ratio * dim), dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x, emb):
        y = self.conv_dw(x).permute(0, 2, 3, 1)
        y = F.layer_norm(y, (self.dim,), eps=1e-6)
        shift, scale = self.embedding_layer(gelu(emb)).chunk(2, dim=-1)
        y = y * (1.0 + scale[:, None, None, :]) + shift[:, None, None, :]
        y = self.mlp(y) * self.gamma
        return y.permute(0, 3, 1, 2) + x


class PlainBlock(nn.Module):
    """ConvNeXt block: depthwise conv, LayerNorm (eps 1e-6, affine), MLP
    (ratio 2), layer scale, residual."""

    def __init__(self, dim, k):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, k, padding=(k - 1) // 2,
                                 groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 2 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        y = self.norm(self.conv_dw(x).permute(0, 2, 3, 1))
        return (self.mlp(y) * self.gamma).permute(0, 3, 1, 2) + x


class PlainDown(nn.Module):
    def __init__(self, dim, cout, rate, k):
        super().__init__()
        self.block = PlainBlock(dim, k)
        self.downsample = Down(dim, cout, rate)

    def forward(self, x):
        return self.downsample(self.block(x))


class VDBlock(nn.Module):
    """Four convs (1x1, kxk, kxk, 1x1; k = 3 or 1), each after a GELU; no
    residual."""

    def __init__(self, cin, hidden, cout, use_3x3):
        super().__init__()
        k = 3 if use_3x3 else 1
        self.c1 = conv(cin, hidden, 1)
        self.c2 = conv(hidden, hidden, k)
        self.c3 = conv(hidden, hidden, k)
        self.c4 = conv(hidden, cout, 1)

    def forward(self, x):
        for c in (self.c1, self.c2, self.c3, self.c4):
            x = c(gelu(x))
        return x


def _scale(plogv):
    return torch.exp(softplus(plogv + 2.3) - 2.3)


class QarvLatent(nn.Module):
    """QARV's latent block: prior (AdaLN block, 1x1 conv to mean and
    log-scale), posterior (AdaLN branches, concatenation, 3x3 conv), fuse
    (1x1 z projection, AdaLN block). kind 'small' keeps one posterior
    branch."""

    def __init__(self, width, zdim, enc_key, enc_width, k, mlp_ratio, kind,
                 embed_dim):
        super().__init__()
        self.zdim, self.enc_key, self.small = zdim, enc_key, kind == 'small'
        self.resnet_front = AdaLNBlock(width, embed_dim, k, mlp_ratio)
        self.resnet_end = AdaLNBlock(width, embed_dim, k, mlp_ratio)
        if not self.small:
            self.posterior0 = AdaLNBlock(enc_width, embed_dim, k, 2)
            self.posterior1 = AdaLNBlock(width, embed_dim, k, 2)
            self.posterior2 = AdaLNBlock(width, embed_dim, k, 2)
        else:
            self.posterior2 = AdaLNBlock(width, embed_dim, k, mlp_ratio)
        self.post_merge = conv(width + enc_width, width, 1)
        self.posterior = conv(width, zdim, 3)
        self.z_proj = conv(zdim, width, 1)
        self.prior = conv(width, zdim * 2, 1)

    def prior_of(self, x, emb):
        f = self.resnet_front(x, emb)
        pm, plogv = self.prior(f).chunk(2, dim=1)
        return f, pm, _scale(plogv)

    def posterior_mean(self, f, enc, emb):
        if not self.small:
            enc = self.posterior0(enc, emb)
            f = self.posterior1(f, emb)
        merged = self.post_merge(torch.cat([f, enc], dim=1))
        return self.posterior(self.posterior2(merged, emb))

    def fuse(self, f, z, emb):
        return self.resnet_end(f + self.z_proj(z), emb)


class QresLatent(nn.Module):
    """QRes-VAE's latent block: prior (plain block, VDBlock to mean and
    log-scale), posterior (VDBlock on the concatenation), fuse (z
    projection: kxk conv, GELU, 1x1 conv; plain block)."""

    def __init__(self, width, zdim, k, rescale_z):
        super().__init__()
        self.zdim = zdim
        hidden = width // 4
        use_3x3 = k >= 3
        self.resnet_front = PlainBlock(width, k)
        self.resnet_end = PlainBlock(width, k)
        self.posterior = VDBlock(2 * width, hidden, zdim, use_3x3)
        self.prior = VDBlock(width, hidden, zdim * 2, use_3x3)
        self.z_proj_0 = conv(zdim, hidden // 2, 3 if use_3x3 else 1)
        self.z_proj_1 = conv(hidden // 2, width, 1)
        # flax's init: the prior's last conv is zero, the z projection's
        # last conv is scaled (weights.seeded_flax_state)
        self.prior.c4.init_scale = 0.0
        self.z_proj_1.init_scale = rescale_z

    def prior_of(self, x, emb=None):
        f = self.resnet_front(x)
        pm, plogv = self.prior(f).chunk(2, dim=1)
        return f, pm, _scale(plogv)

    def posterior_mean(self, f, enc, emb=None):
        return self.posterior(torch.cat([f, enc], dim=1))

    def fuse(self, f, z, emb=None):
        z = self.z_proj_1(gelu(self.z_proj_0(z)))
        return self.resnet_end(f + z)


def _block(spec, embed_dim):
    kind, *a = spec
    if kind == 'down':
        return Down(*a)
    if kind == 'up':
        return Up(*a)
    if kind == 'key':
        return Marker('key', a[0])
    if kind == 'stop':
        return Marker('stop')
    if kind == 'rb':
        return AdaLNBlock(a[0], embed_dim, a[1], a[2])
    if kind == 'cnx':
        return PlainBlock(*a)
    if kind == 'cnxdown':
        return PlainDown(*a)
    if kind == 'latent':
        return QarvLatent(*a, embed_dim)
    if kind == 'qlatent':
        return QresLatent(*a)
    raise ValueError(f'unknown block kind {kind!r}')


class CodecNet(nn.Module):
    """A hierarchical VAE of either family from a configuration's `net`
    entry: {'family': 'qarv' | 'qres', 'enc': [...], 'dec': [...],
    'im_shift', 'im_scale', 'max_stride', and for QARV 'embed_dim',
    'lmb_range', 'sin_period'}."""

    def __init__(self, cfg):
        super().__init__()
        self.family = cfg['family']
        self.qarv = self.family == 'qarv'
        ed = cfg.get('embed_dim', 0)
        self.enc_blocks = nn.ModuleList(_block(s, ed) for s in cfg['enc'])
        self.dec_blocks = nn.ModuleList(_block(s, ed) for s in cfg['dec'])
        self.im_shift, self.im_scale = cfg['im_shift'], cfg['im_scale']
        self.max_stride = cfg['max_stride']
        width = cfg['dec'][0][1]
        self.bias = nn.Parameter(torch.zeros(1, width, 1, 1))
        if self.qarv:
            self.sin_period = cfg['sin_period']
            self.lmb_range = cfg['lmb_range']
            self.max_lmb = cfg['max_lmb']
            self.lmb_embed_0 = nn.Linear(ed, ed)
            self.lmb_embed_1 = nn.Linear(ed, ed)
        self.stop = stop_index(cfg['dec'])
        lo, hi, n = cfg['scale_table']
        step = (math.log(hi) - math.log(lo)) / (n - 1)
        self.register_buffer('scale_table', torch.tensor(
            [math.exp(math.log(lo) + i * step) for i in range(n)]),
            persistent=False)

    # ---- pieces ---------------------------------------------------------

    def embedding(self, lmb):
        """(B,) lambdas -> the (B, E) lambda embedding (QARV), else None."""
        if not self.qarv:
            return None
        E = self.lmb_embed_0.in_features
        v = torch.log(lmb) * (self.sin_period / math.log(self.max_lmb))
        freqs = torch.pow(float(self.sin_period),
                          -torch.linspace(0.0, 1.0, E // 2,
                                          device=lmb.device))
        args = v[:, None] * freqs[None, :]
        e = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        return self.lmb_embed_1(gelu(self.lmb_embed_0(e)))

    def _apply(self, blk, x, emb):
        return blk(x, emb) if isinstance(blk, AdaLNBlock) else blk(x)

    def features(self, im, emb):
        """Encoder features of an NCHW image in [0, 1]: QARV's at its key
        markers, QRes's by height (the last block at each)."""
        x = (im + self.im_shift) * self.im_scale
        feats = {}
        for blk in self.enc_blocks:
            if isinstance(blk, Marker):
                feats[blk.key] = x
                continue
            x = self._apply(blk, x, emb)
            if not self.qarv:
                feats[int(x.shape[2])] = x
        return feats

    def _enc_feature(self, blk, feats, f):
        return feats[blk.enc_key] if self.qarv else feats[int(f.shape[2])]

    def _seed(self, B, nH, nW):
        return self.bias.expand(B, -1, nH, nW)

    def _grid(self, im):
        s = self.max_stride
        return im.shape[2] // s, im.shape[3] // s

    def _tail(self, x, emb):
        for blk in list(self.dec_blocks)[self.stop:]:
            if not isinstance(blk, Marker):
                x = self._apply(blk, x, emb)
        return x

    # ---- the codec ------------------------------------------------------

    def encode(self, im, lmb=None):
        """-> (per latent block the int symbols round(qm - pm) as float32
        NCHW, the feature at the stop marker)."""
        syms, x, _ = self._encode(im, lmb)
        return syms, x

    def table_scale(self, scale):
        """The scale that the codec's table gives `scale`: its smallest
        entry at or above it, the last past the end."""
        t = self.scale_table
        i = torch.searchsorted(t, torch.clamp(scale, min=t[0]).contiguous())
        return t[torch.clamp(i, max=len(t) - 1)]

    def _encode(self, im, lmb):
        """encode's symbols and feature, and per image the ideal bits of
        its symbols: -log2 of each symbol's unit-bin mass under its prior
        (the Gaussian of mean pm and the block's scale rounded up to the
        table), summed."""
        emb = self.embedding(lmb)
        feats = self.features(im, emb)
        x = self._seed(im.shape[0], *self._grid(im))
        syms, bits = [], torch.zeros(im.shape[0], device=im.device)
        for blk in list(self.dec_blocks)[:self.stop]:
            if isinstance(blk, (QarvLatent, QresLatent)):
                f, pm, scale = blk.prior_of(x, emb)
                qm = blk.posterior_mean(f, self._enc_feature(blk, feats, f),
                                        emb)
                s = torch.round(qm - pm)
                syms.append(s)
                bits = bits - log_prob_mass(
                    pm, self.table_scale(scale), s + pm).sum(
                    dim=(1, 2, 3)) / math.log(2.0)
                x = blk.fuse(f, s + pm, emb)
            else:
                x = self._apply(blk, x, emb)
        return syms, x, bits

    def decode(self, syms, lmb=None, grid=None):
        """Symbols (as encode gives them) -> the image, NCHW float32 in
        [0, 1]."""
        emb = self.embedding(lmb)
        B = syms[0].shape[0]
        x = self._seed(B, *grid)
        it = iter(syms)
        for blk in list(self.dec_blocks)[:self.stop]:
            if isinstance(blk, (QarvLatent, QresLatent)):
                f, pm, _ = blk.prior_of(x, emb)
                x = blk.fuse(f, next(it) + pm, emb)
            else:
                x = self._apply(blk, x, emb)
        return torch.clamp(self._tail(x, emb), -1.0, 1.0) * 0.5 + 0.5

    def reconstruct(self, im, lmb=None):
        """decode(encode(im)) in one pass: the decode side's priors are the
        encode side's, computed on the same symbols."""
        return self.code(im, lmb)[0]

    def code(self, im, lmb=None):
        """-> (the reconstruction, per image the ideal bits of its
        symbols)."""
        emb = self.embedding(lmb)
        _, x, bits = self._encode(im, lmb)
        return torch.clamp(self._tail(x, emb), -1.0, 1.0) * 0.5 + 0.5, bits

    # ---- the training loss ----------------------------------------------

    def sample_lmb(self, n, generator, device):
        """Per-image lambdas, uniform in cube-root space."""
        lo, hi = (v ** (1 / 3) for v in self.lmb_range)
        u = torch.rand((n,), generator=generator, device=device)
        return torch.pow(u * (hi - lo) + lo, 3)

    def train_loss(self, im, generator, mse_lmb=None):
        """The training loss of an NCHW float32 batch in [0, 1]: QARV draws
        its lambdas, then each latent block's U(-0.5, 0.5) noise, in block
        order, from `generator`; QRes takes the fixed `mse_lmb`. With no
        generator (counting operations) the noise is zero and lambda 128."""
        B, C, H, W = im.shape
        dev = im.device if generator is None else generator.device
        if not self.qarv:
            lmb = None
        elif generator is None:
            lmb = torch.full((B,), 128.0, device=dev)
        else:
            lmb = self.sample_lmb(B, generator, dev)
        emb = self.embedding(lmb)
        feats = self.features(im, emb)
        x = self._seed(B, *self._grid(im))
        kl = 0.0
        for blk in self.dec_blocks:
            if isinstance(blk, (QarvLatent, QresLatent)):
                shape = (B, blk.zdim) + tuple(x.shape[2:])
                noise = (torch.zeros(shape, device=dev) if generator is None
                         else torch.rand(shape, generator=generator,
                                         device=dev) - 0.5)
                f, pm, pv = blk.prior_of(x, emb)
                z = blk.posterior_mean(f, self._enc_feature(blk, feats, f),
                                       emb) + noise.to(x.device)
                kl = kl - log_prob_mass(pm, pv, z).sum(dim=(1, 2, 3))
                x = blk.fuse(f, z, emb)
            elif not isinstance(blk, Marker):
                x = self._apply(blk, x, emb)
        rate = kl / float(C * H * W)
        mse = torch.square(x - (im - 0.5) * 2.0).mean(dim=(1, 2, 3))
        w = lmb if self.qarv else mse_lmb
        return torch.mean(rate + w * mse)


def stop_index(dec):
    """Where the encode side stops: the stop marker, else after the last
    latent block."""
    kinds = [b[0] for b in dec]
    if 'stop' in kinds:
        return kinds.index('stop')
    return 1 + max(i for i, k in enumerate(kinds) if 'latent' in k)


def log_prob_mass(mean, scale, x, prob_clamp=1e-6):
    """log P of a unit bin of Normal(mean, scale) at x, with the log-pdf
    where the mass is below prob_clamp."""
    def cdf(v):
        return 0.5 * (1.0 + torch.erf(v * (1.0 / math.sqrt(2.0))))
    upper = cdf((x + 0.5 - mean) / scale)
    lower = cdf((x - 0.5 - mean) / scale)
    mass = upper - lower
    zz = (x - mean) / scale
    log_pdf = -0.5 * zz * zz - torch.log(scale) - 0.5 * math.log(2 * math.pi)
    return torch.where(mass > prob_clamp,
                       torch.log(torch.clamp(mass, min=1e-8)), log_pdf)
