"""The RD model of ``lvae_tpu/models/rd/model.py`` in PyTorch: a
continuous-latent variable-rate VAE that estimates the rate-distortion
bound. It has no entropy coding: the rate is the analytic Gaussian KL of
each latent, so bpp = sum(KL) * log2(e) / (H * W).

Every layer is a library call (convolutions, products, LayerNorms) in
exact float32: the JAX model runs no Pallas kernel either. Noise is drawn
through models/entropy_coding.normal_noise from an explicit generator.
"""
import math
from collections import defaultdict

import numpy as np
import torch
import torch.nn as nn

from lvae_tpu_torch.models import base, common
from lvae_tpu_torch.models import entropy_coding as ec
from lvae_tpu_torch.models.base import VAEModelBase, exact_f32, host_stats
from lvae_tpu_torch.utils import coding

MAX_LMB = 8192.0
log2_e = math.log2(math.e)
_SOFTPLUS_BETA = math.log(2.0)


class ConvNeXtAdaLNPatchDown(nn.Module):
    """An AdaLN ConvNeXt block, then a patch downsample to out_ch."""

    requires_embedding = True

    def __init__(self, dim, out_ch, down_rate=2, embed_dim=256,
                 kernel_size=7, mlp_ratio=2):
        super().__init__()
        self.block = common.ConvNeXtBlockAdaLN(dim, embed_dim,
                                               kernel_size=kernel_size,
                                               mlp_ratio=mlp_ratio)
        self.downsample = common.patch_downsample(dim, out_ch,
                                                  rate=down_rate)

    def forward(self, x, emb):
        return self.downsample(self.block(x, emb))


def linear_sqrt(x, threshold=6.0):
    """Soft companding: sign(x) |x|^(1 - tanh|x| / 2) up to |x| = threshold,
    sign(x) sqrt(|x| + 1e-8) beyond; x == 0 returns x itself (the power is
    taken of 1 there, whose gradient is finite)."""
    x_abs = torch.abs(x)
    safe_abs = torch.where(x_abs == 0, torch.ones_like(x_abs), x_abs)
    soft = torch.sign(x) * torch.pow(safe_abs, 1.0 - 0.5 * torch.tanh(x_abs))
    soft = torch.where(x_abs == 0, x, soft)
    signed_sqrt = torch.sign(x) * torch.sqrt(x_abs + 1e-8)
    return torch.where(x_abs <= threshold, soft, signed_sqrt)


def gaussian_kl(mu1, v1, mu2, v2):
    """KL(N(mu1, v1^2) || N(mu2, v2^2)); v1, v2 are standard deviations."""
    return (-0.5 + torch.log(v2) - torch.log(v1)
            + 0.5 * (v1 ** 2 + (mu1 - mu2) ** 2) / (v2 ** 2))


def std_smooth(v, beta=_SOFTPLUS_BETA, threshold=12.0):
    """softplus(beta v) / beta with beta = ln 2, the identity where beta v >
    threshold (torch's softplus rule), in jax.nn.softplus's logaddexp form
    as the JAX package computes it."""
    return torch.where(v * beta > threshold, v,
                       common.softplus(v * beta) / beta)


class LatentVariableBlock(nn.Module):
    """Continuous latent block: AdaLN prior, a posterior of three AdaLN
    blocks and a concat merge, z = qm + qv * eps, a 1x1 z projection.
    use_linear_sqrt=False is the 'Old' variant (no companding of the
    means)."""

    is_latent_block = True
    requires_embedding = True

    def __init__(self, width, zdim, embed_dim, enc_width=None,
                 kernel_size=7, mlp_ratio=2, use_linear_sqrt=True):
        super().__init__()
        B = common.ConvNeXtBlockAdaLN
        w, ks, mr, ed = width, kernel_size, mlp_ratio, embed_dim
        enc_width = enc_width or w
        self.width, self.zdim = width, zdim
        self.use_linear_sqrt = use_linear_sqrt
        self.resnet_front = B(w, ed, kernel_size=ks, mlp_ratio=mr)
        self.resnet_end = B(w, ed, kernel_size=ks, mlp_ratio=mr)
        # the posterior's blocks take the default mlp_ratio, not the
        # block's (lvae_tpu/models/rd/model.py:92-94)
        self.posterior0 = B(enc_width, ed, kernel_size=ks)
        self.posterior1 = B(w, ed, kernel_size=ks)
        self.posterior2 = B(w, ed, kernel_size=ks)
        self.post_merge = common.conv_k1s1(w + enc_width, w)
        self.posterior = common.conv_k3s1(w, zdim * 2)
        self.prior = common.conv_k1s1(w, zdim * 2)
        self.z_proj = common.conv_k1s1(zdim, w)

    def transform_prior(self, feature, emb):
        feature = self.resnet_front(feature, emb)
        pm, pv = self.prior(feature).chunk(2, dim=1)
        if self.use_linear_sqrt:
            pm = linear_sqrt(pm)
        return feature, pm, std_smooth(pv)

    def transform_posterior(self, feature, enc_feature, emb):
        enc_feature = self.posterior0(enc_feature, emb)
        feature = self.posterior1(feature, emb)
        merged = self.post_merge(torch.cat([feature, enc_feature], dim=1))
        merged = self.posterior2(merged, emb)
        qm, qv = self.posterior(merged).chunk(2, dim=1)
        if self.use_linear_sqrt:
            qm = linear_sqrt(qm)
        return qm, std_smooth(qv)

    def forward_train(self, feature, enc_feature, emb, training=True,
                      get_latent=False, noise=None):
        """-> (feature, {'kl': KL(q || p)[, 'z': z]}), z = qm + qv * `noise`,
        the caller's standard normal draw of the posterior's shape and dtype
        (training or not: the model always samples)."""
        feature, pm, pv = self.transform_prior(feature, emb)
        qm, qv = self.transform_posterior(feature, enc_feature, emb)
        kl = gaussian_kl(qm.float(), qv.float(), pm.float(), pv.float())
        z = qm + qv * noise
        feature = self.resnet_end(feature + self.z_proj(z), emb)
        stats = {'kl': kl}
        if get_latent:
            stats['z'] = z.detach()
        return feature, stats

    forward = forward_train

    def forward_uncond(self, feature, emb, t=1.0, latent=None,
                       generator=None):
        """Sampling: z = pm + pv * eps * t from the prior, or `latent`."""
        feature, pm, pv = self.transform_prior(feature, emb)
        if latent is None:
            z = pm + pv * ec.normal_noise(pm, generator) * t
        else:
            z = latent
        return self.resnet_end(feature + self.z_proj(z), emb)


def LatentVariableBlockOld(width, zdim, embed_dim, enc_width=None,
                           kernel_size=7, mlp_ratio=2):
    """The non-companded variant under its original name."""
    return LatentVariableBlock(width, zdim, embed_dim, enc_width=enc_width,
                               kernel_size=kernel_size, mlp_ratio=mlp_ratio,
                               use_linear_sqrt=False)


class RDVAENet(nn.Module):
    """The RD network: encoder blocks (features keyed by their height),
    latent decoder blocks, the seed bias and the lambda embedding."""

    def __init__(self, enc_blocks, dec_blocks, im_shift, im_scale,
                 max_stride=64, lmb_range=(4.0, 2048.0),
                 lmb_embed_dim=(256, 256), sin_period=64):
        super().__init__()
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.im_shift, self.im_scale = im_shift, im_scale
        self.max_stride, self.sin_period = max_stride, sin_period
        self.lmb_range = lmb_range
        self.lmb_embed_dim = lmb_embed_dim
        self.bias = nn.Parameter(torch.zeros(1, dec_blocks[0].width, 1, 1))
        self.lmb_embed_0 = nn.Linear(lmb_embed_dim[0], lmb_embed_dim[1])
        self.lmb_embed_1 = nn.Linear(lmb_embed_dim[1], lmb_embed_dim[1])

    def get_lmb_embedding(self, lmb):
        """(B,) lambdas -> (B, embed_dim): log(lambda) * 64 / log(8192)
        through a sinusoid and two dense layers, in float32 (on the
        bf16-rounded weights in the bf16 training forward)."""
        scaled = torch.log(lmb) * (self.sin_period / math.log(MAX_LMB))
        emb = common.sinusoidal_embedding(scaled, dim=self.lmb_embed_dim[0],
                                          max_period=self.sin_period)
        emb = common.gelu(common.apply_promoted(self.lmb_embed_0, emb))
        return common.apply_promoted(self.lmb_embed_1, emb)

    def encode(self, x, emb, remat=False):
        """-> {height: the last encoder feature at that height}."""
        features = {}
        for block in self.enc_blocks:
            if getattr(block, 'requires_embedding', False):
                x = common.apply_block(block, x, emb, remat=remat)
            else:
                x = common.apply_block(block, x, remat=remat)
            features[int(x.shape[2])] = x
        return features

    def seed_feature(self, batch, h, w):
        return self.bias.expand(batch, -1, h, w)

    def _walk(self, feature, emb, latent_fn):
        """The decoder from the seed: latent blocks through latent_fn(i,
        block, feature), the others as they are."""
        idx = 0
        for block in self.dec_blocks:
            if getattr(block, 'is_latent_block', False):
                feature = latent_fn(idx, block, feature)
                idx += 1
            elif getattr(block, 'requires_embedding', False):
                feature = block(feature, emb)
            else:
                feature = block(feature)
        return feature

    def forward_end2end(self, im, lmb, training=True, get_latents=False,
                        generator=None, remat=False):
        """NCHW image in [0, 1] (in the compute dtype), (B,) lambdas -> (the
        decoder's output, one stats dict per latent block). Each latent
        block's noise is drawn from `generator` before the block runs;
        remat checkpoints every block (common.apply_block)."""
        x = (im + self.im_shift) * self.im_scale
        emb = self.get_lmb_embedding(lmb).to(x.dtype)
        enc_features = self.encode(x, emb, remat)
        f0 = enc_features[min(enc_features)]
        feature = self.seed_feature(f0.shape[0], f0.shape[2], f0.shape[3])
        stats_all = []
        for block in self.dec_blocks:
            if getattr(block, 'is_latent_block', False):
                noise = common.latent_noise(ec.normal_noise, block, feature,
                                            generator)
                feature, stats = common.apply_block(
                    block, feature, enc_features[int(feature.shape[2])], emb,
                    training, get_latents, noise, remat=remat)
                stats_all.append(stats)
            elif getattr(block, 'requires_embedding', False):
                feature = common.apply_block(block, feature, emb, remat=remat)
            else:
                feature = common.apply_block(block, feature, remat=remat)
        return feature, stats_all

    forward = forward_end2end

    def forward_sampling(self, lmb, latents, bhw_repeat, t=1.0,
                         generator=None):
        """The decoder on given latents (NCHW; None entries sample from the
        prior at temperature t)."""
        emb = self.get_lmb_embedding(lmb)
        nB, nH, nW = bhw_repeat
        return self._walk(
            self.seed_feature(nB, nH, nW), emb,
            lambda i, block, f: block.forward_uncond(
                f, emb, t, latent=latents[i], generator=generator))


class RDModel(VAEModelBase):
    """User-facing RD-model handle: the training forward's loss and stats,
    the theoretical-rate sweep (self_evaluate) and sampling. Outputs are
    NHWC float32 numpy in [0, 1]."""

    def __init__(self, net, device=None):
        super().__init__(net, device)
        self.lmb_range = tuple(float(v) for v in net.lmb_range)
        self.default_lmb = self.lmb_range[1]
        self.num_latents = sum(1 for b in net.dec_blocks
                               if getattr(b, 'is_latent_block', False))

    def sample_lmb(self, n, generator=None):
        """Per-image lambda, log-uniform over lmb_range."""
        lo, hi = (math.log(v) for v in self.lmb_range)
        u = ec.draw(torch.rand, (n,), generator, device=self.device)
        return torch.exp(u * (hi - lo) + lo)

    def loss_and_stats(self, im, lmb=None, training=True, generator=None,
                       compute_dtype=None, remat=False):
        """Loss and stats of an NCHW float32 batch in [0, 1] on the device:
        rate (the blocks' KL over the pixels) + lambda * MSE on the [-1, 1]
        scale; lambdas drawn (sample_lmb) when not given. compute_dtype and
        remat as QarvModel.loss_and_stats's (lvae_tpu/models/rd/model.py:
        268-290)."""
        nB, C, H, W = im.shape
        if lmb is None:
            lmb = self.sample_lmb(nB, generator)
        x_hat, stats_all = base.cast_forward(
            self.net, compute_dtype, im, lmb, training, False, generator,
            remat)
        x_hat = x_hat.float()
        kl = sum(st['kl'].float().sum(dim=(1, 2, 3))
                 for st in stats_all) / float(C * H * W)
        distortion = torch.square(x_hat - (im - 0.5) * 2.0).mean(
            dim=(1, 2, 3))
        loss = torch.mean(kl + lmb * distortion)
        im_hat = torch.clamp(x_hat, -1, 1) * 0.5 + 0.5
        stats = {'loss': loss, 'bppix': torch.mean(kl) * log2_e * C,
                 'mse': torch.mean(distortion),
                 'mse_im': torch.mean(torch.square(im_hat - im))}
        return loss, stats

    def forward(self, im, lmb=None, seed=0, generator=None):
        """The training forward's stats of image(s) (NHWC in [0, 1], sides
        divisible by the stride) at `lmb` (default_lmb when None; a scalar
        or one per image), the latents' noise from a generator on the
        device seeded `seed`, or from `generator` (on the CPU: the same
        noise for a CPU and a card run): {'loss', 'bppix', 'mse', 'psnr'}
        as floats. Exact float32 whatever the process's TF32 flags."""
        im = self._checked(im)
        lmb = self._lmbs(self.default_lmb if lmb is None else lmb,
                         im.shape[0])
        with torch.no_grad(), exact_f32():
            _, stats = self.loss_and_stats(
                im, lmb, generator=self._generator(seed, generator))
            return host_stats(stats)

    # ---- sampling (lvae_tpu/models/rd/model.py:314-339) -----------------

    def conditional_sample(self, lmb, latents, bhw_repeat=None, t=1.0,
                           seed=0, generator=None):
        """The decoder on `latents` (NHWC arrays, one a latent block; None:
        all sampled at temperature t on a (nB, nH, nW) bhw_repeat grid) ->
        NHWC float32 numpy in [0, 1]."""
        if latents is None:
            latents = [None] * self.num_latents
            assert bhw_repeat is not None
            nB, nH, nW = bhw_repeat
        else:
            assert len(latents) == self.num_latents
            nB, nH, nW = np.shape(latents[0])[:3]
        latents = base.latents_to_device(latents, self.device)
        with torch.no_grad(), exact_f32():
            x = self.net.forward_sampling(
                self._lmbs(lmb, nB), latents, (nB, nH, nW), t,
                self._generator(seed, generator))
            return base.nhwc_numpy(torch.clamp(x, -1, 1) * 0.5 + 0.5)

    def unconditional_sample(self, lmb, bhw_repeat, t=1.0, seed=0,
                             generator=None):
        return self.conditional_sample(lmb, None, bhw_repeat=bhw_repeat,
                                       t=t, seed=seed, generator=generator)

    def study(self, save_dir, **kwargs):
        """Write the unconditional sample grids
        (models/base.py:save_sample_grids)."""
        base.save_sample_grids(self, save_dir)

    # ---- the theoretical-rate sweep (lvae_tpu/models/rd/model.py:
    # 341-371) -----------------------------------------------------------

    def self_evaluate(self, img_dir, lmb_range=None, steps=8, log_dir=None):
        """Theoretical bpp, PSNR and loss of the PNGs under `img_dir`
        (centre-cropped to the stride) at `steps` lambdas linear in
        lambda^(1/3) over lmb_range (the model's when None) -> {'loss',
        'bpp', 'psnr', 'lambda': one value per lambda}."""
        img_paths = coding.image_paths(img_dir)
        start, end = self.lmb_range if lmb_range is None else lmb_range
        p = 3.0
        lambdas = np.linspace(start ** (1 / p), end ** (1 / p), steps) ** p
        all_lmb_stats = defaultdict(list)
        for lmb in lambdas.tolist():
            for k, v in self._self_evaluate(img_paths, lmb).items():
                all_lmb_stats[k].append(v)
        return dict(all_lmb_stats)

    def _self_evaluate(self, img_paths, lmb):
        accum = defaultdict(float)
        for impath in img_paths:
            img = coding.crop_divisible_by(coding.read_png(impath),
                                           self.max_stride)
            stats = self.forward(img.astype(np.float32)[None] / 255.0,
                                 lmb=lmb)
            accum['loss'] += stats['loss']
            accum['bpp'] += stats['bppix']
            accum['psnr'] += stats['psnr']
        avg = {k: v / len(img_paths) for k, v in accum.items()}
        avg['lambda'] = lmb
        return avg
