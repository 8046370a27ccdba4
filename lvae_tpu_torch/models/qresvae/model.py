"""QRes-VAE (fixed-rate hierarchical VAE) of
``lvae_tpu/models/qresvae/model.py`` in PyTorch, with the MSE output head or
the lossless (GaussianNLL) pixel head: the codec and the training/eval
forward.

Containers (the JAX package's, so that a file of either package opens in
the other):
    compress()        -> fused:  [body, (1, nH, nW, width)], body the fused
                                 payload (models/fused_base.py)
                         host:   [[string per image] per latent block...,
                                 (nB, fH, fW, C) of the encoder's last
                                 feature (NHWC order)[, [head string per
                                 image]]] (lossless: the pixel head's)
                         device: [payload (models/staged.py), (1, fH, fW,
                                 C)]
    compress_file()   -> pickle of compress()'s list + [(h, w)]
"""
import io
import math
import pickle

import numpy as np
import torch
import torch.nn as nn

from lvae_tpu_torch.models import base, common, staged
from lvae_tpu_torch.models import entropy_coding as ec
from lvae_tpu_torch.models.base import (VAEModelBase, exact_f32, host_image,
                                         host_stats)
from lvae_tpu_torch.models.qresvae import fused
from lvae_tpu_torch.ops import cdf as cdf_ops
from lvae_tpu_torch.utils import coding, trace

log2_e = math.log2(math.e)


class MSEOutputNet(nn.Module):
    """The lambda * MSE output head (lvae_tpu/models/qresvae/model.py:34):
    the decoder's last feature is the image; it has no weights."""

    loss_name = 'mse'

    def __init__(self, mse_lmb):
        super().__init__()
        self.mse_lmb = float(mse_lmb)

    def forward_loss(self, x_hat, x_tgt):
        """-> (lambda * per-image MSE, x_hat)."""
        mse = torch.square(x_hat - x_tgt).mean(dim=(1, 2, 3))
        return mse * self.mse_lmb, x_hat

    def mean(self, x_hat, temprature=None):
        return x_hat

    def sample(self, x_hat, generator=None, temprature=None):
        return x_hat


class GaussianNLLOutputNet(nn.Module):
    """The per-pixel discretized-Gaussian head of the lossless models
    (lvae_tpu/models/qresvae/model.py:53-99): two patch_upsample convs give
    each pixel's mean and log-scale; a pixel is coded as the integer distance
    of its value from the mean rounded to the 255-level grid, against a
    128-entry scale table in bin units, so it decodes exactly."""

    loss_name = 'nll'

    def __init__(self, conv_mean, conv_scale, bin_size=1 / 127.5):
        super().__init__()
        self.conv_mean, self.conv_scale = conv_mean, conv_scale
        self.bin_size = bin_size

    def _params(self, feature):
        """NCHW feature -> (pixel means, log-scales floored at -16) through
        the library convs, in float32 (on bf16-rounded weights in the bf16
        training forward); softplus in jax.nn.softplus's form, as the JAX
        module computes it."""
        feature = feature.float()
        p_mean = common.apply_promoted(self.conv_mean, feature)
        p_logscale = common.softplus(
            common.apply_promoted(self.conv_scale, feature) + 16.0) - 16.0
        return p_mean, p_logscale

    def forward_loss(self, feature, x_tgt):
        """-> (per-image mean NLL of the pixels x_tgt in [-1, 1], means)."""
        p_mean, p_logscale = self._params(feature)
        log_prob = ec.gaussian_log_prob_mass(
            p_mean, torch.exp(p_logscale), x_tgt, bin_size=self.bin_size)
        return -log_prob.mean(dim=(1, 2, 3)), p_mean

    def mean(self, feature, temprature=None):
        return self._params(feature)[0]

    def sample(self, feature, generator=None, temprature=None):
        """Pixels drawn from each pixel's Gaussian (its scale times
        temprature when given), the noise from `generator`."""
        p_mean, p_logscale = self._params(feature)
        p_scale = torch.exp(p_logscale)
        if temprature is not None:
            p_scale = p_scale * temprature
        return p_mean + p_scale * ec.normal_noise(p_mean, generator)

    def codec_tensors(self, feature):
        """The legacy trunk's head: NCHW feature -> (pm, plogv) in bin units,
        NCHW."""
        p_mean, p_logscale = self._params(feature)
        pm = torch.round(p_mean * 127.5 + 127.5) / 127.5 - 1.0
        pm = pm / self.bin_size
        return pm, p_logscale - math.log(self.bin_size)


class QLatentBlock(nn.Module):
    """Fixed-rate latent block (lvae_tpu/models/qresvae/model.py:117):
    ConvNeXt front and end, VDBlock posterior and zero-initialised VDBlock
    prior, softplus log-scale floor -2.3, a two-conv z projection."""

    is_latent_block = True
    # the eval likelihood's scale bound: the JAX package keeps 0.11 though
    # the coding table starts at 0.1 (lvae_tpu/models/qresvae/model.py:134)
    eval_scale_bound = 0.11

    def __init__(self, width, zdim, enc_width=None, kernel_size=7,
                 rescale_z=1.0):
        super().__init__()
        enc_width = enc_width or width
        self.width, self.zdim, self.kernel_size = width, zdim, kernel_size
        hidden = int(max(width, enc_width) * 0.25)
        use_3x3 = kernel_size >= 3
        self.resnet_front = common.MyConvNeXtBlock(width, kernel_size)
        self.resnet_end = common.MyConvNeXtBlock(width, kernel_size)
        self.posterior = common.VDBlock(width + enc_width, hidden, zdim,
                                        residual=False, use_3x3=use_3x3)
        self.prior = common.VDBlock(width, hidden, zdim * 2, residual=False,
                                    use_3x3=use_3x3, zero_last=True)
        zc = common.conv_k3s1 if use_3x3 else common.conv_k1s1
        self.z_proj_0 = zc(zdim, hidden // 2)
        self.z_proj_1 = common.conv_k1s1(hidden // 2, width)
        self.z_proj_1.init_scale = rescale_z          # common.flax_init_
        # kept on the module's device, so that the scale-index lookup copies
        # nothing from the host
        self.register_buffer('scale_table', torch.as_tensor(
            cdf_ops.qres_latent_scale_table(), dtype=torch.float32),
            persistent=False)

    def prior_stage(self, feature):
        """p(z_i | z_<i) -> (feature_mid, pm, pv, coding indexes int32)."""
        feature, pm, pv = self._prior(feature)
        return feature, pm, pv, ec.build_indexes(pv, self.scale_table)

    def _prior(self, feature):
        feature = self.resnet_front(feature)
        pm, plogv = self.prior(feature).float().chunk(2, dim=1)
        return feature, pm, torch.exp(common.softplus(plogv + 2.3) - 2.3)

    def posterior_qm(self, feature, enc_feature):
        return self.posterior(torch.cat([feature, enc_feature], dim=1))

    def fuse_stage(self, feature, pm, symbols):
        return self._fuse(feature, symbols.float() + pm.float())

    def _fuse(self, feature, z):
        # z in one layout whatever made it (a posterior conv's output is
        # channels-last on the CPU, a latent given to cond_sample is not),
        # so that the z projection's sums do not depend on its source; in
        # the feature's dtype (the bf16 training forward's eval branch)
        z = z.to(feature.dtype).contiguous()
        z = self.z_proj_1(common.gelu(self.z_proj_0(z)))
        return self.resnet_end(feature + z)

    def forward_train(self, feature, enc_feature, training=False,
                      get_latents=False, noise=None):
        """The block in the training/eval forward -> (feature, {'kl': -log
        P(z)[, 'z': z]}), as VRLVBlockBase.forward_train without lambda
        (`noise`: the caller's U(-0.5, 0.5) draw when training)."""
        feature, pm, pv = self._prior(feature)
        qm = self.posterior_qm(feature, enc_feature)
        if training:
            z = qm + noise
            kl = -ec.gaussian_log_prob_mass(pm, pv, z, 1.0, 1e-6)
        else:
            z = ec.quantize_dequantize(qm, pm)
            kl = -torch.log(ec.discrete_likelihood(z, pv, pm,
                                                   self.eval_scale_bound))
        stats = {'kl': kl}
        if get_latents:
            stats['z'] = z.detach()
        return self._fuse(feature, z), stats

    forward = forward_train

    def forward_uncond(self, feature, t=1.0, latent=None, paint_mask=None,
                       generator=None):
        """Sampling: z = pm + pv * t * eps + u * t (eps normal, u uniform in
        [-0.5, 0.5), drawn in that order from `generator`), or `latent`;
        with a paint_mask (1 where a fresh sample replaces the latent)
        latent * (1 - mask) + sample * mask."""
        feature, pm, pv = self._prior(feature)
        pv = pv * t
        if latent is None or paint_mask is not None:
            eps = ec.normal_noise(pm, generator)
            u = ec.uniform_noise(pm, generator)
            z = pm + pv * eps + u * t
            if latent is not None:
                z = latent * (1.0 - paint_mask) + z * paint_mask
        else:
            z = latent
        return self._fuse(feature, z)


class HierarchicalVAENet(nn.Module):
    """The QRes-VAE network (lvae_tpu/models/qresvae/model.py:248): encoder
    blocks, decoder blocks, the output head and the decoder's seed bias."""

    def __init__(self, enc_blocks, dec_blocks, out_net, im_shift, im_scale,
                 max_stride=64):
        super().__init__()
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.out_net = out_net
        self.im_shift, self.im_scale = im_shift, im_scale
        self.max_stride = max_stride
        self.bias = nn.Parameter(torch.zeros(1, dec_blocks[0].width, 1, 1))

    def preprocess_input(self, im):
        return (im + self.im_shift) * self.im_scale

    def encode_features(self, im, remat=False, blocks=None):
        """Encoder features keyed by their height: the last block at each
        resolution wins (lvae_tpu/models/qresvae/model.py:102-114); `blocks`
        in place of enc_blocks (the bf16 codec's cast copy)."""
        x = self.preprocess_input(im)
        features = {}
        for block in self.enc_blocks if blocks is None else blocks:
            x = common.apply_block(block, x, remat=remat)
            features[int(x.shape[2])] = x
        return features

    def seed_feature(self, batch, h, w):
        return self.bias.expand(batch, -1, h, w)

    def forward(self, im, training=False, get_latents=False, generator=None,
                remat=False):
        """The training/eval forward: NCHW image in [0, 1] (in the compute
        dtype) -> (the head's per-image loss, its output x_hat, one stats
        dict per latent block). Library convolutions throughout. training
        draws each latent block's noise from `generator`; remat checkpoints
        every block (common.apply_block)."""
        enc_features = self.encode_features(im, remat)
        f0 = enc_features[min(enc_features)]
        feature = self.seed_feature(f0.shape[0], f0.shape[2], f0.shape[3])
        stats_all = []
        for block in self.dec_blocks:
            if getattr(block, 'is_latent_block', False):
                noise = (common.latent_noise(ec.uniform_noise, block,
                                             feature, generator)
                         if training else None)
                feature, stats = common.apply_block(
                    block, feature, enc_features[int(feature.shape[2])],
                    training, get_latents, noise, remat=remat)
                stats_all.append(stats)
            else:
                feature = common.apply_block(block, feature, remat=remat)
        out_loss, x_hat = self.out_net.forward_loss(feature,
                                                    (im - 0.5) * 2.0)
        return out_loss, x_hat, stats_all

    def forward_uncond(self, nhw_repeat=(1, 1, 1), t=1.0, generator=None):
        """The decoder with every latent sampled at temperature t."""
        return self.forward_with_latents(None, nhw_repeat, t,
                                         generator=generator)

    def forward_with_latents(self, latents, nhw_repeat=None, t=1.0,
                             paint_masks=None, generator=None):
        """The decoder on given latents (NCHW; None: all sampled), each
        block's paint mask applied where given; the seed grid is
        nhw_repeat, or the first latent's."""
        if nhw_repeat is None:
            nB, _, nH, nW = latents[0].shape
        else:
            nB, nH, nW = nhw_repeat
        feature = self.seed_feature(nB, nH, nW)
        idx = 0
        for block in self.dec_blocks:
            if getattr(block, 'is_latent_block', False):
                feature = block.forward_uncond(
                    feature, t, None if latents is None else latents[idx],
                    None if paint_masks is None else paint_masks[idx],
                    generator)
                idx += 1
            else:
                feature = block(feature)
        return feature

    def sample_output(self, feature, generator=None, temprature=None):
        return self.out_net.sample(feature, generator, temprature)

    def out_mean(self, feature):
        return self.out_net.mean(feature)


class _Container(pickle.Unpickler):
    """Reads the pickled container of compress_file: lists, tuples, bytes
    and ints only; any class or callable in the file is refused."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(
            f'{module}.{name} in a compressed file: refused')


class QresModel(VAEModelBase):
    """User-facing QRes-VAE handle: single-image and batch compression
    through the fused codec (models/qresvae/fused.py). A lossless model's
    pixels come back exact: decompress returns u8 / 255 as float32, and
    decompress_to_device the uint8 image."""

    codec_classes = (fused.FusedQresCodec, fused.PortableQresCodec)

    def __init__(self, net, device=None):
        super().__init__(net, device)
        self.lossless = isinstance(net.out_net, GaussianNLLOutputNet)
        self._coder = ec.DiscretizedGaussian(
            cdf_ops.qres_latent_scale_table())
        self._head_coder = (ec.DiscretizedGaussian(
            cdf_ops.lossless_head_scale_table()) if self.lossless else None)
        self.num_latents = sum(1 for b in net.dec_blocks
                               if getattr(b, 'is_latent_block', False))
        self.compressing = False

    # ---- the training/eval forward (lvae_tpu/models/qresvae/model.py:
    # 389-468) -----------------------------------------------------------

    def loss_and_stats(self, im, training=True, generator=None,
                       compute_dtype=None, remat=False):
        """Loss and stats of an NCHW float32 batch in [0, 1] on the device:
        rate (the blocks' kl over the pixels) + the head's loss (lambda *
        MSE, or the pixels' NLL). compute_dtype and remat as
        QarvModel.loss_and_stats's (lvae_tpu/models/qresvae/model.py:
        389-410)."""
        out_loss, x_hat, stats_all = base.cast_forward(
            self.net, compute_dtype, im, training, False, generator,
            remat)
        x_hat, out_loss = x_hat.float(), out_loss.float()
        nB, C, H, W = im.shape
        kl = sum(st['kl'].float().sum(dim=(1, 2, 3))
                 for st in stats_all) / (C * H * W)
        loss = torch.mean(kl + out_loss)
        im_hat = torch.clamp(x_hat, -1.0, 1.0) * 0.5 + 0.5
        stats = {'loss': loss, 'kl': torch.mean(kl),
                 self.net.out_net.loss_name: torch.mean(out_loss),
                 'bppix': torch.mean(kl) * log2_e * C,
                 'mse_im': torch.mean(torch.square(im_hat - im))}
        return loss, stats

    def forward(self, im, return_rec=False):
        """Eval stats of image(s) (NHWC in [0, 1], sides divisible by the
        stride): {'loss', 'kl', 'mse' or 'nll', 'bppix', 'psnr'[,
        'im_hat']} as floats, pulled in one copy. Exact float32 whatever
        the process's TF32 flags."""
        im = self._checked(im)
        with torch.no_grad(), exact_f32():
            stats = host_stats(self.loss_and_stats(im, training=False)[1])
        if return_rec:
            stats['im_hat'] = self.reconstruct(im)
        return stats

    def reconstruct(self, im):
        """The forward's reconstruction (the head's means for a lossless
        model): NHWC float32 numpy in [0, 1]."""
        im = self._checked(im)
        with torch.no_grad(), exact_f32():
            _, x_hat, _ = self.net.forward(im)
            rec = torch.clamp(x_hat, -1.0, 1.0) * 0.5 + 0.5
        return rec.permute(0, 2, 3, 1).cpu().numpy()

    # ---- sampling (lvae_tpu/models/qresvae/model.py:473-534) ------------

    def uncond_sample(self, nhw_repeat, temprature=1.0, seed=0,
                      generator=None):
        """Images from the prior on a (nB, nH, nW) latent grid at
        temperature `temprature` -> NHWC float32 numpy in [0, 1]. The noise
        comes from a generator on the device seeded `seed`, or from
        `generator`."""
        return self._sample(None, tuple(nhw_repeat), temprature, None, seed,
                            generator)

    def cond_sample(self, latents, nhw_repeat=None, temprature=1.0,
                    paint_masks=None, seed=0, generator=None):
        """The decoder on `latents` (NHWC arrays, one a latent block, as
        forward_get_latents gives them), fresh samples where a block's
        paint mask (NHWC, broadcast to its latent) is 1 -> NHWC float32
        numpy in [0, 1]. A lossless model draws its pixels from the head."""
        latents = base.latents_to_device(latents, self.device)
        if paint_masks is not None:
            paint_masks = base.latents_to_device(paint_masks, self.device)
        return self._sample(latents, nhw_repeat, temprature, paint_masks,
                            seed, generator)

    def _sample(self, latents, nhw_repeat, temprature, paint_masks, seed,
                generator):
        generator = self._generator(seed, generator)
        with torch.no_grad(), exact_f32():
            feature = self.net.forward_with_latents(
                latents, nhw_repeat, temprature, paint_masks, generator)
            x = self.net.sample_output(feature, generator, temprature)
            return base.nhwc_numpy(torch.clamp(x, -1, 1) * 0.5 + 0.5)

    def forward_get_latents(self, im):
        """Each latent block's eval-forward {'kl', 'z'} (NHWC float32
        numpy): z is what cond_sample takes."""
        return self._latents(self._checked(im))

    def _latents(self, im):
        with torch.no_grad(), exact_f32():
            _, _, stats_all = self.net.forward(im, False, True)
            return [{k: base.nhwc_numpy(v) for k, v in st.items()}
                    for st in stats_all]

    def inpaint(self, im, paint_box, steps=1, temprature=1.0, seed=0):
        """Iterative inpainting of the (x1, y1, x2, y2) box (fractions of
        the image's width and height) of NHWC image(s) in [0, 1]: each step
        takes the latents of the current image, samples them afresh inside
        the box (seed + step) and pastes the sample's box into the input.
        -> the last sample, NHWC float32 numpy."""
        im = base.nhwc_numpy(self._checked(im))     # checked once, as given
        _, imH, imW, _ = im.shape
        x1, y1, x2, y2 = paint_box
        hs = slice(round(y1 * imH), round(y2 * imH))
        ws = slice(round(x1 * imW), round(x2 * imW))
        im_input, im_sample = im.copy(), None
        for i in range(steps):
            latents = [st['z'] for st in self._latents(
                base.to_nchw_batch(im_input, self.device))]
            masks = []
            for z in latents:
                zH, zW = z.shape[1], z.shape[2]
                m = np.zeros((1, zH, zW, 1), np.float32)
                if min(zH, zW) > 1:
                    m[:, round(y1 * zH):round(y2 * zH),
                      round(x1 * zW):round(x2 * zW)] = 1.0
                masks.append(m)
            im_sample = np.clip(self.cond_sample(
                latents, temprature=temprature, paint_masks=masks,
                seed=seed + i), 0, 1)
            im_input = im.copy()
            im_input[:, hs, ws, :] = im_sample[:, hs, ws, :]
        return im_sample

    # ---- the codec ------------------------------------------------------

    def _codec_tables(self):
        """The lossless head's CDF table, coded after the latent blocks."""
        if not self.lossless:
            return {}
        return dict(head_cdf_table=self._head_coder.update())

    def compress_mode(self, mode=True, coder=None, num_lanes=128, **cfg):
        """See VAEModelBase.compress_mode; coder None is 'fused', as in the
        JAX package (lvae_tpu/models/qresvae/model.py:552-553); num_lanes is
        16, 32, 64 or 128 (the JAX package's default 128): a fixed-rate
        model has no lambda to choose it by. The device coder has no
        lossless head."""
        if coder is None:
            coder = 'fused'
        if num_lanes not in (16, 32, 64, 128):
            raise ValueError(f'num_lanes={num_lanes!r}: 16, 32, 64 or 128')
        if coder == 'device' and self.lossless:
            # the JAX package's assertion (qresvae/model.py:555-556)
            raise AssertionError('the staged device coder has no lossless '
                                 'head; use fused/host')
        super().compress_mode(mode, coder, num_lanes, **cfg)

    def _shape(self, im):
        """(1, nH, nW, width) of an NCHW input: the object's second entry."""
        s = self.net.max_stride
        return (1, im.shape[2] // s, im.shape[3] // s,
                int(self.net.bias.shape[1]))

    def compress(self, im, portable=None):
        """Compress one image (NHWC in [0, 1]; the host coder also takes a
        batch, coded image by image) -> the container of the module doc.
        `portable` overrides the compress_mode trunk kind for this stream
        (the fused coder's; the host and device coders run the legacy
        trunk)."""
        if self.coder_kind != 'fused':
            return self._compress_staged(im)[0]
        im = self._to_input(im)
        body = self._get_fused(self.num_lanes, portable=portable).encode(im)
        return [body, self._shape(im)]

    def compress_check(self, im, portable=None):
        """compress() that also returns the image reconstructed from the
        encode-side symbols (NHWC float32 numpy): decompress() must
        reproduce it bitwise. A lossless model's reconstruction is the
        input's exact pixels."""
        if self.coder_kind != 'fused':
            return self._compress_staged(im, want_image=True)
        im = self._to_input(im)
        body, img = self._get_fused(self.num_lanes,
                                    portable=portable).encode_check(im)
        return [body, self._shape(im)], host_image(img)

    def _compress_staged(self, im, want_image=False):
        """The host or device coder's compress -> (container, the
        reconstruction as float32 numpy or None)
        (lvae_tpu/models/qresvae/model.py:660-749)."""
        host = self.coder_kind == 'host'
        im = self._to_input(im, batch=host)
        B = im.shape[0]
        codec = self._staged_codec()
        syms, idx, feature, _, enc_features, img = codec.encode_blocks(
            im, want_image=want_image and not self.lossless)
        if host:
            obj = [[self._coder.compress_symbols(s[b], ix[b])
                    for b in range(B)] for s, ix in zip(syms, idx)]
        else:
            obj = [staged.interleaved_payload(
                [s[0] for s in syms], [i[0] for i in idx],
                self._coder.cdf_table, self.num_lanes)]
        # the encoder's last feature's shape, in the JAX package's NHWC order
        _, C, fH, fW = enc_features[min(enc_features)].shape
        obj.append((B, fH, fW, C))
        rec = None if img is None else host_image(img)
        if self.lossless:
            with torch.no_grad(), codec.trunk_scope():
                pm, plogv = self._head_tensors_host(feature)
                xs = codec._head_symbols(im, pm).cpu().numpy()
            idx = self._head_indexes(plogv)
            obj.append([self._head_coder.compress_symbols(xs[b], idx[b])
                        for b in range(B)])
            if want_image:
                rec = self._head_recon_host(xs, pm.cpu().numpy())
        return obj, rec

    def _head_tensors_host(self, feature):
        """The lossless head's (pm, plogv) on the legacy trunk, (B, H, W, 3)
        in bin units on the device."""
        pm, plogv = self.net.out_net.codec_tensors(feature)
        return (pm.permute(0, 2, 3, 1).contiguous(),
                plogv.permute(0, 2, 3, 1).contiguous())

    def _head_indexes(self, plogv):
        """The host coder's head indexes: exp(plogv) against the float64
        table on the host, as the JAX package's host coder computes them."""
        with np.errstate(over='ignore'):     # inf scales take the last row
            scales = np.exp(plogv.cpu().numpy())
        return cdf_ops.build_indexes_np(scales, self._head_coder.scale_table)

    def _head_recon_host(self, xs, pm):
        """The host coder's pixels: clip((xs + pm) * bin, -1, 1) * 0.5 + 0.5
        in numpy, as the JAX package returns them (float32)."""
        x_hat = (xs + pm) * self.net.out_net.bin_size
        return np.clip(np.asarray(x_hat, np.float32), -1, 1) * 0.5 + 0.5

    def decompress_to_device(self, body, fH, fW):
        """Decode one body -> (1, H, W, 3) image on the device (asynchronous;
        float16, or uint8 for a lossless model), routed by the stream's lane
        field."""
        self._require_fused('decompress_to_device')
        return self._stream_codec([body]).decode_to_device(body, fH, fW)

    def decompress(self, obj):
        """compress()'s container -> (nB, H, W, 3) float32 numpy image(s),
        by the coder compress_mode chose (the fused coder routes by the
        stream's lane field)."""
        if self.coder_kind != 'fused':
            return self._decompress_staged(obj)
        nB, fH, fW, _ = obj[-1]
        if nB != 1:
            raise ValueError(f'stream holds {nB} images; expected 1')
        return host_image(self.decompress_to_device(obj[0], fH, fW))

    def _decompress_staged(self, obj):
        """The host or device coder's decompress
        (lvae_tpu/models/qresvae/model.py:751-847)."""
        if not self.compressing:
            raise RuntimeError('call compress_mode() first')
        obj = list(obj)
        head = obj.pop() if self.lossless else None
        nB, fH, fW, _ = obj.pop()
        codec = self._staged_codec()
        if self.coder_kind == 'device':
            if nB != 1 or len(obj) != 1:
                raise ValueError('a device-coder stream holds one image')
            return host_image(staged.decode_device(codec, obj[0], fH, fW))
        feature, _, img = staged.decode_host(codec, self._coder, obj, nB, fH,
                                             fW, want_image=not self.lossless)
        if not self.lossless:
            return host_image(img)
        with torch.no_grad(), codec.trunk_scope():
            pm, plogv = self._head_tensors_host(feature)
        idx = self._head_indexes(plogv)
        xs = np.stack([self._head_coder.decompress_symbols(
            head[b], idx[b]).reshape(idx[b].shape) for b in range(nB)])
        return self._head_recon_host(xs, pm.cpu().numpy())

    # ---- batch serving (lvae_tpu/models/qresvae/model.py:859-913) -------

    def compress_batch_async(self, ims):
        """Dispatch-only half of compress_batch: queues the encode of B
        same-shape images and returns a handle without synchronising the
        host."""
        self._require_fused('compress_batch')
        with trace.span('enc.request'):
            ims = self._to_input(ims, batch=True)
            codec = self._get_fused(self.num_lanes)
            return codec, codec.encode_batch_async(ims), self._shape(ims)

    def compress_batch_finish(self, handle):
        """Wait for a compress_batch_async dispatch -> its B objects. A
        serving loop dispatches batch k+1 before finishing batch k."""
        codec, fhandle, shape = handle
        with trace.span('enc.finish'):
            return [[body, shape]
                    for body in codec.encode_batch_finish(fhandle)]

    def decompress_batch_to_device(self, objs):
        """Decode B same-shape objects -> (B, H, W, 3) images on the device
        (asynchronous; float16, or uint8 for a lossless model)."""
        self._require_fused('decompress_batch')
        with trace.span('dec.request'):
            shapes = {tuple(o[-1]) for o in objs}
            if len(shapes) != 1:
                raise ValueError(f'batch streams must share one image shape, '
                                 f'got {sorted(shapes)}')
            nB, fH, fW, _ = shapes.pop()
            if nB != 1:
                raise ValueError(f'stream holds {nB} images; expected 1')
            bodies = [o[0] for o in objs]
            return self._stream_codec(bodies).decode_batch_to_device(
                bodies, fH, fW)

    # ---- files ----------------------------------------------------------

    def compress_file(self, img_path, output_path, pad_hw=None,
                      portable=None):
        """Compress a PNG (converted to RGB, read by coding.read_png) into
        the JAX package's pickled container. The image is edge-padded to the
        stride, or to pad_hw, an (H, W) shape bucket divisible by it; decode
        crops back to the stored size. Files are portable streams when the
        codec supports them (supports_portable), so that they decode in any
        process; portable=False writes a legacy stream, bound to the writing
        process. The host and device coders write their own containers
        (compress())."""
        if not self.compressing:
            raise RuntimeError('call compress_mode() first')
        img = coding.read_png(img_path)
        padded = (coding.pad_divisible_by(img, div=self.net.max_stride)
                  if pad_hw is None else coding.pad_to_shape(img, *pad_hw))
        if portable is None and self.coder_kind == 'fused':
            portable = self._fused.supports_portable
        obj = self.compress(padded.astype(np.float32) / 255.0,
                            portable=portable)
        obj.append((int(img.shape[0]), int(img.shape[1])))
        with open(output_path, 'wb') as f:
            pickle.dump(obj, file=f)

    def decompress_file(self, bits_path):
        """-> (1, h, w, 3) float32 numpy image, cropped to the stored size."""
        with open(bits_path, 'rb') as f:
            obj = _Container(io.BytesIO(f.read())).load()
        img_h, img_w = obj.pop()
        return self.decompress(obj)[:, :img_h, :img_w, :]
