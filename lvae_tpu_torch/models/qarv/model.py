"""QARV (variable-rate hierarchical VAE) of ``lvae_tpu/models/qarv/model.py``
in PyTorch: the codec, the training/eval forward and the forward-only
lambda sweep (self_evaluate).

Bitstream layout (byte-identical headers to the JAX package):
    file   = [2H img_h img_w][body]
    body   = [f lmb][3H nB nH nW][payload]
    payload: the fused payload (models/fused_base.py), or the host or
    device coder's (models/staged.py), by compress_mode's coder
"""
import math
import struct
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

from lvae_tpu_torch.models import base, common, staged
from lvae_tpu_torch.models import entropy_coding as ec
from lvae_tpu_torch.models.base import (VAEModelBase, exact_f32, host_image,
                                         host_stats)
from lvae_tpu_torch.models.qarv import fused
from lvae_tpu_torch.ops import cdf as cdf_ops
from lvae_tpu_torch.utils import coding, trace

MAX_LMB = 8192.0
log2_e = math.log2(math.e)
# study()'s logging images: the checkout's images/
IMAGES = Path(__file__).resolve().parents[3] / 'images'


class VRLVBlockBase(nn.Module):
    """Variable-rate latent variable block: AdaLN-conditioned prior,
    posterior (3 AdaLN blocks + concat merge) and fuse."""

    is_latent_block = True
    eval_scale_bound = 0.11      # the default scale table's minimum

    def __init__(self, width, zdim, enc_key, enc_width, embed_dim=256,
                 kernel_size=7, mlp_ratio=2):
        super().__init__()
        self.width, self.zdim, self.enc_key = width, zdim, enc_key
        self.kernel_size = kernel_size
        B = common.ConvNeXtBlockAdaLN
        w, ks, mr, ed = width, kernel_size, mlp_ratio, embed_dim
        self.resnet_front = B(w, ed, kernel_size=ks, mlp_ratio=mr)
        self.resnet_end = B(w, ed, kernel_size=ks, mlp_ratio=mr)
        self._posterior_branches(enc_width, ed, ks, mr)
        self.post_merge = common.conv_k1s1(w + enc_width, w)
        self.posterior = common.conv_k3s1(w, zdim)
        self.z_proj = common.conv_k1s1(zdim, w)
        self.prior = common.conv_k1s1(w, zdim * 2)
        # kept on the module's device, so that the scale-index lookup copies
        # nothing from the host (no synchronisation in a batch dispatch)
        self.register_buffer('scale_table', torch.as_tensor(
            cdf_ops.default_gaussian_scale_table(), dtype=torch.float32),
            persistent=False)

    def _posterior_branches(self, enc_width, ed, ks, mr):
        B = common.ConvNeXtBlockAdaLN
        self.posterior0 = B(enc_width, ed, kernel_size=ks)
        self.posterior1 = B(self.width, ed, kernel_size=ks)
        self.posterior2 = B(self.width, ed, kernel_size=ks)

    def prior_stage(self, feature, emb):
        """p(z_i | z_<i) -> (feature_mid, pm, pv, coding indexes int32)."""
        feature, pm, pv = self._prior(feature, emb)
        return feature, pm, pv, ec.build_indexes(pv, self.scale_table)

    def _prior(self, feature, emb):
        feature = self.resnet_front(feature, emb)
        pm, plogv = self.prior(feature).float().chunk(2, dim=1)
        return feature, pm, torch.exp(common.softplus(plogv + 2.3) - 2.3)

    def posterior_qm(self, feature, enc_feature, emb):
        enc_feature = self.posterior0(enc_feature, emb)
        feature = self.posterior1(feature, emb)
        merged = self.post_merge(torch.cat([feature, enc_feature], dim=1))
        return self.posterior(self.posterior2(merged, emb))

    def fuse_stage(self, feature, pm, symbols, emb):
        return self._fuse(feature, symbols.float() + pm.float(), emb)

    def _fuse(self, feature, z, emb):
        # one layout of z whatever made it (qresvae/model.py:_fuse), in the
        # feature's dtype (the bf16 training forward's eval branch)
        z = z.to(feature.dtype).contiguous()
        return self.resnet_end(feature + self.z_proj(z), emb)

    def forward_train(self, feature, enc_feature, emb, training=False,
                      get_latent=False, noise=None):
        """The block in the training/eval forward -> (feature, {'kl': -log
        P(z)[, 'z': z]}). training: z = posterior mean + `noise`, the
        U(-0.5, 0.5) draw of the posterior's shape and dtype that the caller
        makes (common.latent_noise), P the Gaussian's mass at z; eval: z the
        quantized residual, P its discretized likelihood."""
        feature, pm, pv = self._prior(feature, emb)
        qm = self.posterior_qm(feature, enc_feature, emb)
        if training:
            z = qm + noise
            kl = -ec.gaussian_log_prob_mass(pm, pv, z, 1.0, 1e-6)
        else:
            z = ec.quantize_dequantize(qm, pm)
            kl = -torch.log(ec.discrete_likelihood(z, pv, pm,
                                                   self.eval_scale_bound))
        stats = {'kl': kl}
        if get_latent:
            stats['z'] = z.detach()
        return self._fuse(feature, z, emb), stats

    forward = forward_train

    def forward_uncond(self, feature, emb, t=1.0, latent=None,
                       generator=None):
        """Sampling: z = pm + pv * eps * t + u * t (eps normal, u uniform in
        [-0.5, 0.5), drawn in that order from `generator`), or `latent`."""
        feature, pm, pv = self._prior(feature, emb)
        if latent is None:
            eps = ec.normal_noise(pm, generator)
            u = ec.uniform_noise(pm, generator)
            z = pm + pv * eps * t + u * t
        else:
            z = latent
        return self._fuse(feature, z, emb)


class VRLVBlockSmall(VRLVBlockBase):
    """Lighter posterior: concat-merge only."""

    def _posterior_branches(self, enc_width, ed, ks, mr):
        self.posterior2 = common.ConvNeXtBlockAdaLN(self.width, ed,
                                                    kernel_size=ks,
                                                    mlp_ratio=mr)

    def posterior_qm(self, feature, enc_feature, emb):
        merged = self.post_merge(torch.cat([feature, enc_feature], dim=1))
        return self.posterior(self.posterior2(merged, emb))


class VariableRateLossyVAENet(nn.Module):
    """The QARV network: encoder backbone, latent decoder blocks and the
    lambda embedding."""

    def __init__(self, enc_blocks, dec_blocks, im_shift, im_scale,
                 max_stride=64, lmb_range=(16.0, 2048.0),
                 lmb_embed_dim=(256, 256), sin_period=64):
        super().__init__()
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.im_shift, self.im_scale = im_shift, im_scale
        self.max_stride, self.sin_period = max_stride, sin_period
        self.lmb_range = lmb_range
        self.lmb_embed_dim = lmb_embed_dim
        width = dec_blocks[0].width
        self.bias = nn.Parameter(torch.zeros(1, width, 1, 1))
        self.lmb_embed_0 = nn.Linear(lmb_embed_dim[0], lmb_embed_dim[1])
        self.lmb_embed_1 = nn.Linear(lmb_embed_dim[1], lmb_embed_dim[1])

    def get_lmb_embedding(self, lmb):
        """lmb: (B,) float -> (B, embed_dim), computed in float32 (on the
        bf16-rounded weights in the bf16 training forward)."""
        scaled = torch.log(lmb) * (self.sin_period / math.log(MAX_LMB))
        emb = common.sinusoidal_embedding(scaled, dim=self.lmb_embed_dim[0],
                                          max_period=self.sin_period)
        emb = common.gelu(common.apply_promoted(self.lmb_embed_0, emb))
        return common.apply_promoted(self.lmb_embed_1, emb)

    def preprocess_input(self, im):
        return (im + self.im_shift) * self.im_scale

    def encode_features(self, im, emb, remat=False, blocks=None):
        """Encoder backbone -> {key: feature} at the SetKey markers; `blocks`
        in place of enc_blocks (the bf16 codec's cast copy)."""
        x = self.preprocess_input(im)
        features = {}
        for block in self.enc_blocks if blocks is None else blocks:
            if isinstance(block, common.SetKey):
                features[block.key] = x
            elif getattr(block, 'requires_embedding', False):
                x = common.apply_block(block, x, emb, remat=remat)
            else:
                x = common.apply_block(block, x, remat=remat)
        return features

    def seed_feature(self, batch, h, w):
        return self.bias.expand(batch, -1, h, w)

    def forward_end2end(self, im, lmb, training=False, get_latent=False,
                        generator=None, remat=False):
        """The training/eval forward: NCHW image in [0, 1] (in the compute
        dtype), (B,) lambdas -> (the decoder's output, one stats dict per
        latent block). Library convolutions throughout (no kernel of
        ops/trunk.py). training draws each latent block's noise from
        `generator`; remat checkpoints every block (common.apply_block)."""
        # the embedding in the compute dtype, as the JAX forward casts it
        emb = self.get_lmb_embedding(lmb).to(im.dtype)
        enc_features = self.encode_features(im, emb, remat)
        s = self.max_stride
        feature = self.seed_feature(im.shape[0], im.shape[2] // s,
                                    im.shape[3] // s)
        block_stats = []
        for block in self.dec_blocks:
            if getattr(block, 'is_latent_block', False):
                noise = (common.latent_noise(ec.uniform_noise, block,
                                             feature, generator)
                         if training else None)
                feature, stats = common.apply_block(
                    block, feature, enc_features[block.enc_key], emb,
                    training, get_latent, noise, remat=remat)
                block_stats.append(stats)
            elif getattr(block, 'requires_embedding', False):
                feature = common.apply_block(block, feature, emb, remat=remat)
            elif not isinstance(block, common.CompressionStopFlag):
                feature = common.apply_block(block, feature, remat=remat)
        return feature, block_stats

    forward = forward_end2end

    def forward_sampling(self, lmb, latents, bhw_repeat, t=1.0,
                         generator=None):
        """The decoder on given latents (NCHW; None entries sample from the
        prior at temperature t) from a (nB, nH, nW) seed."""
        emb = self.get_lmb_embedding(lmb)
        nB, nH, nW = bhw_repeat
        feature = self.seed_feature(nB, nH, nW)
        idx = 0
        for block in self.dec_blocks:
            if getattr(block, 'is_latent_block', False):
                feature = block.forward_uncond(feature, emb, t, latents[idx],
                                               generator)
                idx += 1
            elif getattr(block, 'requires_embedding', False):
                feature = block(feature, emb)
            elif not isinstance(block, common.CompressionStopFlag):
                feature = block(feature)
        return feature


class QarvModel(VAEModelBase):
    """User-facing QARV handle: single-image and batch compression through
    the fused codec (models/qarv/fused.py)."""

    codec_classes = (fused.FusedQarvCodec, fused.PortableQarvCodec)

    def __init__(self, net, device=None, log_images=()):
        super().__init__(net, device)
        self.lmb_range = tuple(float(v) for v in net.lmb_range)
        self.default_lmb = self.lmb_range[1]
        self._logging_images = list(log_images)
        self.num_latents = sum(1 for b in net.dec_blocks
                               if getattr(b, 'is_latent_block', False))
        self._coder = ec.DiscretizedGaussian()
        self.compressing = False

    # ---- the training/eval forward (lvae_tpu/models/qarv/model.py:
    # 383-491) -----------------------------------------------------------

    def sample_lmb(self, n, generator=None):
        """Per-image lambda, uniform in cube-root space."""
        low, high = self.lmb_range
        lo, hi = low ** (1 / 3), high ** (1 / 3)
        u = ec.draw(torch.rand, (n,), generator, device=self.device)
        return torch.pow(u * (hi - lo) + lo, 3)

    def loss_and_stats(self, im, lmb=None, training=True, generator=None,
                       compute_dtype=None, remat=False):
        """Loss and stats of an NCHW float32 batch in [0, 1] on the device:
        rate (the blocks' kl over the pixels) + lambda * MSE on the [-1, 1]
        scale. Lambdas are drawn (sample_lmb) when not given.
        compute_dtype='bfloat16' runs the network on bf16 casts of its
        float32 parameters and of the image (base.cast_forward): x_hat, kl
        and the distortion come back as float32, and the rate's probability
        math stays float32 (entropy_coding). remat=True checkpoints every
        block of the encoder and the decoder (lvae_tpu/models/qarv/model.py:
        401-437)."""
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

    def forward(self, im, lmb=None, return_rec=False):
        """Eval stats of image(s) (NHWC in [0, 1], sides divisible by the
        stride) at `lmb` (default_lmb when None; a scalar or one per image):
        {'loss', 'bppix', 'mse', 'psnr'[, 'im_hat']} as floats, pulled in
        one copy. Exact float32 whatever the process's TF32 flags."""
        im = self._checked(im)
        lmb = self._lmbs(self.default_lmb if lmb is None else lmb,
                         im.shape[0])
        with torch.no_grad(), exact_f32():
            stats = host_stats(self.loss_and_stats(im, lmb,
                                                   training=False)[1])
        if return_rec:
            stats['im_hat'] = self.reconstruct(im, lmb)
        return stats

    def reconstruct(self, im, lmb):
        """The forward's reconstruction: NHWC float32 numpy in [0, 1]."""
        im = self._checked(im)
        with torch.no_grad(), exact_f32():
            x_hat, _ = self.net.forward_end2end(im,
                                                self._lmbs(lmb, im.shape[0]))
            rec = torch.clamp(x_hat, -1, 1) * 0.5 + 0.5
        return rec.permute(0, 2, 3, 1).cpu().numpy()

    # ---- sampling (lvae_tpu/models/qarv/model.py:493-548) ---------------

    def conditional_sample(self, lmb, latents, bhw_repeat=None, t=1.0,
                           seed=0, generator=None):
        """The decoder on `latents` (NHWC arrays, one a latent block, as
        forward_get_latents gives them; None entries sampled at temperature
        t, on a (nB, nH, nW) bhw_repeat grid when the first is None) ->
        NHWC float32 numpy in [0, 1]. The noise comes from a generator on
        the device seeded `seed`, or from `generator`."""
        if latents[0] is None:
            assert bhw_repeat is not None
            nB, nH, nW = bhw_repeat
        else:
            assert len(latents) == self.num_latents
            nB, nH, nW = np.shape(latents[0])[:3]
        latents = base.latents_to_device(latents, self.device)
        with torch.no_grad(), exact_f32():
            x = self.net.forward_sampling(self._lmbs(lmb, nB), latents,
                                          (nB, nH, nW), t,
                                          self._generator(seed, generator))
            return base.nhwc_numpy(torch.clamp(x, -1, 1) * 0.5 + 0.5)

    def unconditional_sample(self, lmb, bhw_repeat, t=1.0, seed=0,
                             generator=None):
        return self.conditional_sample(lmb, [None] * self.num_latents,
                                       bhw_repeat=bhw_repeat, t=t, seed=seed,
                                       generator=generator)

    def forward_get_latents(self, im, lmb=None):
        """Each latent block's eval-forward {'kl', 'z'} (NHWC float32
        numpy): z is what conditional_sample takes."""
        im = self._checked(im)
        lmb = self._lmbs(self.default_lmb if lmb is None else lmb,
                         im.shape[0])
        with torch.no_grad(), exact_f32():
            _, stats_all = self.net.forward_end2end(im, lmb, False, True)
            return [{k: base.nhwc_numpy(v) for k, v in st.items()}
                    for st in stats_all]

    def study(self, save_dir, **kwargs):
        """Write the unconditional sample grids (models/base.py:
        save_sample_grids) and, for each logging image found in the
        checkout's images/, the image beside its reconstruction at the
        default lambda."""
        save_dir = base.save_sample_grids(self, save_dir)
        for imname in self._logging_images:
            impath = IMAGES / imname
            if not impath.is_file():
                continue
            im = coding.read_png(impath).astype(np.float32)[None] / 255.0
            rec = self.reconstruct(im, self.default_lmb)
            coding.write_png(save_dir / imname, coding.batch_to_image(
                np.concatenate([im[0], rec[0]], axis=1)))

    # ---- forward-only lambda sweep (lvae_tpu/models/qarv/model.py:550-679)

    def self_evaluate(self, img_dir, lmb_range=None, steps=8, log_dir=None,
                      shape_buckets=0):
        """Estimated rate and quality of the PNGs under `img_dir` at `steps`
        lambdas log-spaced over lmb_range (the model's when None) ->
        {'loss', 'bpp', 'psnr', 'lambda': one value per lambda}.
        shape_buckets > 0 pads the images into at most that many (H, W)
        buckets, the stats masked to each image; log_dir: write the
        per-channel rates (channel-bppix-lmb*.txt, all_lmb_channel_stats.txt)
        there."""
        img_paths = coding.image_paths(img_dir)
        buckets = None
        if shape_buckets:
            sizes = [coding.png_size(p) for p in img_paths]
            buckets = coding.choose_shape_buckets(
                sizes, div=self.max_stride, max_buckets=shape_buckets)
        start, end = self.lmb_range if lmb_range is None else lmb_range
        lambdas = np.exp(np.linspace(math.log(start), math.log(end), steps))
        all_lmb_stats = defaultdict(list)
        for lmb in lambdas.tolist():
            results = self._self_evaluate(img_paths, lmb, log_dir=log_dir,
                                          buckets=buckets)
            for k, v in results.items():
                all_lmb_stats[k].append(v)
        return dict(all_lmb_stats)

    def _eval_stats(self, pad_u8, lmb, imgh, imgw):
        """Eval stats of one edge-padded uint8 NCHW image on the device,
        reduced there over its true (imgh, imgw) region -> one float32
        vector [kl total, distortion, mse, channel bpp...]. The kl total
        sums the whole padded latents; the channel bpp divide by the padded
        area (the JAX package's numbers)."""
        padH, padW = pad_u8.shape[2:]
        im = pad_u8.float() / 255.0
        x_hat, stats_all = self.net.forward_end2end(im, lmb)
        mask = ((torch.arange(padH, device=im.device)[None, None, :, None]
                 < imgh) &
                (torch.arange(padW, device=im.device)[None, None, None, :]
                 < imgw))
        npix = float(imgh * imgw * 3)
        distortion = torch.sum(torch.square(x_hat - (im - 0.5) * 2.0)
                               * mask) / npix
        fake = torch.clamp(x_hat, -1, 1) * 0.5 + 0.5
        mse = torch.sum(torch.square(im - fake) * mask) / npix
        kl_total = sum(torch.sum(st['kl']) for st in stats_all)
        ch_bpp = [st['kl'].sum(dim=(2, 3)).mean(0) / (padH * padW) * log2_e
                  for st in stats_all]
        return torch.cat([torch.stack([kl_total, distortion, mse])]
                         + ch_bpp)

    def _self_evaluate(self, img_paths, lmb, log_dir=None, buckets=None):
        accum = defaultdict(float)
        channel_bpp_sums = defaultdict(lambda: 0.0)
        zdims = [blk.zdim for blk in self.net.dec_blocks
                 if getattr(blk, 'is_latent_block', False)]
        edges = np.cumsum([0] + zdims) + 3      # after the three scalars
        count = 0
        s = self.max_stride
        lmb_t = self._lmbs(lmb, 1)
        for impath in img_paths:
            img = coding.read_png(impath)
            imgh, imgw = img.shape[:2]
            if buckets is not None:
                padH, padW = coding.bucket_for(imgh, imgw, buckets)
            else:
                padH, padW = imgh + (-imgh % s), imgw + (-imgw % s)
            pad_u8 = torch.from_numpy(np.ascontiguousarray(
                coding.pad_to_shape(img, padH, padW))).to(self.device)
            with torch.no_grad(), exact_f32():
                out = self._eval_stats(pad_u8.permute(2, 0, 1)[None], lmb_t,
                                       imgh, imgw).cpu().numpy()
            kl = float(out[0]) / (3 * imgh * imgw)
            psnr = -10 * math.log10(max(float(out[2]), 1e-12))
            count += 1
            accum['loss'] += kl + lmb * float(out[1])
            accum['bpp'] += kl * log2_e * 3
            accum['psnr'] += psnr
            if log_dir is not None:
                for i in range(len(zdims)):
                    channel_bpp_sums[i] = (channel_bpp_sums[i]
                                           + out[edges[i]:edges[i + 1]])
        avg = {k: v / count for k, v in accum.items()}
        avg['lambda'] = lmb
        if log_dir is not None:
            self._log_channel_stats(channel_bpp_sums, count, Path(log_dir),
                                    lmb)
        return avg

    @staticmethod
    def _log_channel_stats(channel_bpp_sums, count, log_dir, lmb):
        """Append the per-channel and per-block average rates to
        channel-bppix-lmb<lambda>.txt and all_lmb_channel_stats.txt."""
        msg = '=' * 64 + '\n'
        msg += ('---- row: latent blocks, colums: channels, avg over images '
                '----\n')
        keys = sorted(channel_bpp_sums.keys())
        for k in keys:
            avg = channel_bpp_sums[k] / count
            msg += ''.join(f'{a:<7.4f} '
                           for a in np.atleast_1d(avg).tolist()) + '\n'
        msg += '---- colums: latent blocks, avg over images ----\n'
        block_bpps = [float(np.sum(channel_bpp_sums[k] / count))
                      for k in keys]
        msg += ''.join(f'{a:<7.4f} ' for a in block_bpps) + '\n'
        log_dir.mkdir(parents=True, exist_ok=True)
        with open(log_dir / f'channel-bppix-lmb{round(lmb)}.txt', 'a') as f:
            print(msg, file=f)
        with open(log_dir / 'all_lmb_channel_stats.txt', 'a') as f:
            print(msg, file=f)

    # ---- the codec ------------------------------------------------------

    @staticmethod
    def _auto_lanes(lmb: float) -> int:
        """Rate-adaptive lane count: low-rate streams use fewer lanes so the
        per-image lane-state flush stays under ~1% of the payload."""
        if lmb <= 48:
            return 16
        if lmb <= 384:
            return 32
        if lmb <= 1536:
            return 64
        return 128

    @staticmethod
    def _round_lmb(lmb):
        # struct 'f' stores float32; use the same rounded value on both sides
        return struct.unpack('f', struct.pack('f', float(lmb)))[0]

    def _prepare(self, im, lmb, portable):
        im = self._to_input(im)
        lmb_f32 = self._round_lmb(lmb if lmb is not None
                                  else self.default_lmb)
        n = (self._auto_lanes(lmb_f32) if self.num_lanes == 'auto'
             else self.num_lanes)
        fused = self._get_fused(n, portable=portable)
        if portable is None:
            self._fused = fused
        return im, lmb_f32, fused

    def _header(self, lmb_f32, nH, nW):
        return struct.pack('f', lmb_f32) + struct.pack('3H', 1, nH, nW)

    def _grid(self, im):
        return im.shape[2] // self.max_stride, im.shape[3] // self.max_stride

    def compress(self, im, lmb=None, portable=None):
        """Compress one image (NHWC in [0,1]) -> bytes. `portable`
        overrides the compress_mode trunk kind for this stream (the fused
        coder's; the host and device coders run the legacy trunk)."""
        if self.coder_kind != 'fused':
            return self._compress_staged(im, lmb)[0]
        im, lmb_f32, fused = self._prepare(im, lmb, portable)
        body = fused.encode(im, self._lmb_tensor([lmb_f32]))
        return self._header(lmb_f32, *self._grid(im)) + body

    def compress_check(self, im, lmb=None, portable=None):
        """compress() that also returns the image reconstructed from the
        encode-side symbols (NHWC float32): decompress() must reproduce it
        bitwise."""
        if self.coder_kind != 'fused':
            stream, img = self._compress_staged(im, lmb, want_image=True)
            return stream, host_image(img)
        im, lmb_f32, fused = self._prepare(im, lmb, portable)
        body, img = fused.encode_check(im, self._lmb_tensor([lmb_f32]))
        return (self._header(lmb_f32, *self._grid(im)) + body,
                img.float().cpu().numpy())

    def _compress_staged(self, im, lmb, want_image=False):
        """The host or device coder's compress -> (stream, the tail's image
        on the device or None) (lvae_tpu/models/qarv/model.py:846-939)."""
        im = self._to_input(im)
        lmb_f32 = self._round_lmb(lmb if lmb is not None
                                  else self.default_lmb)
        syms, idx, _, _, _, img = self._staged_codec().encode_blocks(
            im, self._lmb_tensor([lmb_f32]), want_image=want_image)
        syms, idx = [s[0] for s in syms], [i[0] for i in idx]
        if self.coder_kind == 'device':
            body = staged.interleaved_payload(
                syms, idx, self._coder.cdf_table, self.num_lanes)
        else:
            body = coding.pack_byte_strings([
                self._coder.compress_symbols(s, ix)
                for s, ix in zip(syms, idx)])
        return self._header(lmb_f32, *self._grid(im)) + body, img

    def _lmb_tensor(self, lmbs):
        """(B,) float32 lambdas on the device, copied from pinned memory
        without synchronising the host."""
        t = torch.tensor(lmbs, dtype=torch.float32)
        if self.device.type == 'cuda':
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ---- batch serving (lvae_tpu/models/qarv/model.py:941-1024) --------

    def compress_batch_async(self, ims, lmb=None):
        """Dispatch-only half of compress_batch: queues the encode of B
        same-shape images and returns an opaque handle without
        synchronising the host; compress_batch_finish gives the streams.
        lmb: a scalar or one lambda per image."""
        self._require_fused('compress_batch')
        with trace.span('enc.request'):
            ims = self._to_input(ims, batch=True)
            B = ims.shape[0]
            if lmb is None:
                lmb = self.default_lmb
            lmbs = [self._round_lmb(v)
                    for v in (lmb if np.ndim(lmb) else [lmb] * B)]
            if len(lmbs) != B:
                raise ValueError(f'{len(lmbs)} lambdas for {B} images')
            # one lane count for the batch: with 'auto', the largest any
            # image would choose alone, which keeps the high-rate images'
            # latency
            fused = self._get_fused(max(self._auto_lanes(v) for v in lmbs)
                                    if self.num_lanes == 'auto'
                                    else self.num_lanes)
            self._fused = fused
            handle = fused.encode_batch_async(ims, self._lmb_tensor(lmbs))
            return fused, handle, lmbs, self._grid(ims)

    def compress_batch_finish(self, handle):
        """Wait for a compress_batch_async dispatch and return its B
        streams. A serving loop dispatches batch k+1 before finishing batch
        k, hiding the payload copy and stream assembly behind device
        compute."""
        fused, fhandle, lmbs, (nH, nW) = handle
        with trace.span('enc.finish'):
            bodies = fused.encode_batch_finish(fhandle)
            # standard single-image streams: [f lmb][3H 1 nH nW][body]
            return [self._header(v, nH, nW) + b
                    for v, b in zip(lmbs, bodies)]

    def decompress_batch_to_device(self, strings):
        """Decode B same-shape streams -> (B, H, W, 3) float16 images on the
        device (asynchronous). Routed by the streams' lane field, which all
        of them must share."""
        self._require_fused('decompress_batch')
        with trace.span('dec.request'):
            lmbs, bodies, shapes = [], [], set()
            for s in strings:
                lmb_v, = struct.unpack('f', s[:4])
                nB, nH, nW = struct.unpack('3H', s[4:10])
                if nB != 1:
                    raise ValueError(f'stream holds {nB} images; expected 1')
                shapes.add((nH, nW))
                lmbs.append(lmb_v)
                bodies.append(s[10:])
            if len(shapes) != 1:
                raise ValueError(f'batch streams must share one image shape, '
                                 f'got latent grids {sorted(shapes)}')
            (nH, nW), = shapes
            return self._stream_codec(bodies).decode_batch_to_device(
                bodies, nH, nW, self._lmb_tensor(lmbs))

    # ---- decode ---------------------------------------------------------

    def decompress_to_device(self, *args):
        """Decode -> (1, H, W, 3) float16 image on the device.
        decompress_to_device(stream), or the JAX package's form
        decompress_to_device(lmb, nB, nH, nW, body) with the stream's
        header fields given apart from its body."""
        self._require_fused('decompress_to_device')
        if len(args) == 1:
            string, = args
            lmb, = struct.unpack('f', string[:4])
            nB, nH, nW = struct.unpack('3H', string[4:10])
            body = string[10:]
        elif len(args) == 5:
            lmb, nB, nH, nW, body = args
        else:
            raise TypeError('decompress_to_device(stream) or '
                            'decompress_to_device(lmb, nB, nH, nW, body)')
        if nB != 1:
            raise ValueError(f'stream holds {nB} images; expected 1')
        return self._stream_codec([body]).decode_to_device(
            body, nH, nW, self._lmb_tensor([lmb]))

    def decompress(self, string):
        """Decode -> (1, H, W, 3) float32 numpy image in [0,1], by the coder
        compress_mode chose (the fused coder routes by the stream's lane
        field)."""
        if self.coder_kind == 'fused':
            return self.decompress_to_device(string).float().cpu().numpy()
        if not self.compressing:
            raise RuntimeError('call compress_mode() first')
        lmb, = struct.unpack('f', string[:4])
        nB, nH, nW = struct.unpack('3H', string[4:10])
        if nB != 1:
            raise ValueError(f'stream holds {nB} images; expected 1')
        codec, lmb_t = self._staged_codec(), self._lmb_tensor([lmb])
        if self.coder_kind == 'device':
            return host_image(staged.decode_device(codec, string[10:], nH,
                                                   nW, lmb_t))
        blocks = ([s] for s in coding.unpack_byte_string(string[10:]))
        _, _, img = staged.decode_host(codec, self._coder, blocks, 1, nH, nW,
                                       lmb_t)
        return host_image(img)

    def compress_file(self, img_path, output_path, lmb=None, pad_hw=None,
                      portable=None):
        """Compress a PNG (converted to RGB, read by coding.read_png) into a
        file: [2H h w][compress()]. The image is edge-padded to the stride,
        or to pad_hw, an (H, W) shape bucket divisible by it; decode crops
        back to the stored size. Files are portable streams when the codec
        supports them (supports_portable), so that they decode in any
        process (lvae_tpu/models/qarv/model.py:1157-1158); portable=False
        writes a legacy stream, bound to the writing process. The host and
        device coders write their own streams (compress())."""
        if not self.compressing:
            raise RuntimeError('call compress_mode() first')
        img = coding.read_png(img_path)
        padded = (coding.pad_divisible_by(img, div=self.net.max_stride)
                  if pad_hw is None else coding.pad_to_shape(img, *pad_hw))
        if portable is None and self.coder_kind == 'fused':
            portable = self._fused.supports_portable
        body = self.compress(padded.astype(np.float32) / 255.0, lmb=lmb,
                             portable=portable)
        with open(output_path, 'wb') as f:
            f.write(struct.pack('2H', img.shape[0], img.shape[1]) + body)

    def decompress_file(self, bits_path):
        """-> (1, h, w, 3) float32 numpy image, cropped to the stored size."""
        with open(bits_path, 'rb') as f:
            header, body = f.read(4), f.read()
        img_h, img_w = struct.unpack('2H', header)
        return self.decompress(body)[:, :img_h, :img_w, :]
