"""The fused QRes-VAE codec of ``lvae_tpu/models/qresvae/fused.py`` (MSE or
lossless head), for single images and batches, on either trunk
(models/fused_base.py holds the trunk loop both directions run, the payload,
the lossless head's block and batching).

QARV's construction without the lambda conditioning: the per-image context
is empty and the encoder features are keyed by their resolution (the last
block at each one wins). With the MSE head the trunk runs to the last latent
block, and the synthesis tail (the final patch_upsample) and the pixel
finish run only on decode and in the self-check. With the lossless
(GaussianNLL) head the whole decoder chain and the head's means and scale
indexes are trunk, and the pixels are one more coded block
(qresvae/fused.py:103-136, 155-158).

* legacy (``FusedQresCodec``): the modules' library calls, NCHW.
* portable (``PortableQresCodec``): the plain ConvNeXt blocks, the VDBlock
  prior and its scale indexes, the z-projection junction, the 1x1 convs of
  the upsamplers, the tail's last conv with the pixel finish (one launch),
  the head's two convs (one launch) and its grid rounding and
  reconstruction from the kernels of ``ops/trunk.py``.
"""
import torch

from lvae_tpu_torch.models import common
from lvae_tpu_torch.models.base import cpu_lowp_convs
from lvae_tpu_torch.models import entropy_coding as ec
from lvae_tpu_torch.models.fused_base import FusedCodecBase, PortableTrunk
from lvae_tpu_torch.ops import cdf as cdf_ops
from lvae_tpu_torch.ops import trunk


class FusedQresCodec(FusedCodecBase):
    """Fused codec for HierarchicalVAENet with the MSE or the lossless head,
    on the legacy trunk; PortableQresCodec overrides the trunk's stages. A
    lossless net needs `head_cdf_table` (QresModel passes it)."""

    supports_portable = True

    def __init__(self, net, cdf_table, head_cdf_table=None, **cfg):
        head = getattr(net.out_net, 'loss_name', None)
        if head not in ('mse', 'nll') or (head == 'nll') != (
                head_cdf_table is not None):
            raise NotImplementedError(
                f'output head {type(net.out_net).__name__}: the codec codes '
                f'the MSE head and the lossless (GaussianNLL) head, the '
                f'latter with its head_cdf_table')
        super().__init__(net, cdf_table, head_cdf_table=head_cdf_table,
                         **cfg)
        blocks = list(net.dec_blocks)
        if head == 'nll':
            # the head consumes the whole chain's feature: no tail
            self.stop = self.tail_start = len(blocks)
            table = cdf_ops.lossless_head_scale_table().astype('float32')
            # nll_head's search needs it non-decreasing: checked once here
            trunk.require_nondecreasing(table, 'the head scale table')
            self.head_table = torch.as_tensor(table, device=self.device)
        else:
            self.stop = 1 + max(i for i, b in enumerate(blocks)
                                if getattr(b, 'is_latent_block', False))
            self.tail_start = self.stop

    # ---- the trunk's stages; no context ---------------------------------

    def _context(self):
        return ()

    def _prior(self, blk, feature):
        f_mid, pm, _, indexes = blk.prior_stage(feature)
        return f_mid, pm, indexes

    def _fuse(self, blk, f_mid, pm, syms):
        return blk.fuse_stage(f_mid, pm, syms)

    def _plain(self, blk, feature):
        return blk(feature)

    def _backbone(self, im):
        cd = self.compute_dtype
        if cd is None:
            return self.net.encode_features(im)
        # bf16 in, each feature out as float32
        # (lvae_tpu/models/qresvae/fused.py:183-188)
        with cpu_lowp_convs(im.device):
            feats = self.net.encode_features(im.to(cd),
                                             blocks=self.backbone_blocks())
        return {k: v.float() for k, v in feats.items()}

    def _posterior(self, blk, f_mid, enc_features):
        return blk.posterior_qm(f_mid, enc_features[int(f_mid.shape[2])])

    # ---- the lossless head (lvae_tpu/models/qresvae/fused.py:103-136) ---

    def _head_tensors(self, feature):
        """The whole chain's feature -> (pm in bin units, scale indexes),
        each (B, H, W, 3) NHWC: trunk floats, recomputed in both
        directions."""
        pm, plogv = self.net.out_net.codec_tensors(feature)
        idx = ec.build_indexes(torch.exp(plogv), self.head_table)
        return (pm.permute(0, 2, 3, 1).contiguous(),
                idx.permute(0, 2, 3, 1).contiguous())

    def _head_symbols(self, im, pm):
        """Encode side: the pixels' distances from the grid means, im
        (B, 3, H, W) in [0, 1] -> (B, H, W, 3) int32."""
        x = ((im.permute(0, 2, 3, 1) - 0.5) * 2.0) / self.net.out_net.bin_size
        return torch.round(x - pm).to(torch.int32)

    def _head_recon(self, xs, pm):
        """(symbols + pm) * bin -> the exact uint8 pixels (B, H, W, 3)."""
        x_hat = (xs.to(torch.float32) + pm) * self.net.out_net.bin_size
        im = torch.clamp(x_hat, -1.0, 1.0) * 0.5 + 0.5
        return torch.round(im * 255).to(torch.uint8)


class PortableQresCodec(PortableTrunk, FusedQresCodec):
    """The fused codec on the portable trunk
    (lvae_tpu/models/qresvae/fused.py:58-98)."""

    def __init__(self, net, cdf_table, **cfg):
        for blk in net.dec_blocks:
            if not (getattr(blk, 'is_latent_block', False) or isinstance(
                    blk, (common.MyConvNeXtBlock, common.patch_upsample,
                          common.upsample_nearest))):
                # the deconv upsampler of qres17m has no portable kernel
                raise NotImplementedError(
                    f'portable trunk: no kernel for the '
                    f'{type(blk).__name__} block; use portable=False')
        super().__init__(net, cdf_table, **cfg)
        self.table = torch.as_tensor(
            cdf_ops.qres_latent_scale_table().astype('float32'),
            device=self.device)

    def _prior(self, blk, feature):
        f_mid = trunk.convnext_plain(feature, blk.resnet_front)
        pm, idx = trunk.qres_prior_head(f_mid, blk.prior,
                                        blk.kernel_size >= 3, self.table)
        return f_mid, pm, idx

    def _fuse(self, blk, f_mid, pm, syms):
        return trunk.qres_fuse(f_mid, syms, pm, blk)

    def _plain(self, blk, feature):
        if isinstance(blk, common.MyConvNeXtBlock):
            return trunk.convnext_plain(feature, blk)
        return super()._plain(blk, feature)

    def _head_tensors(self, feature):
        onet = self.net.out_net
        m, r = trunk.head_upsample(feature, onet.conv_mean, onet.conv_scale)
        return trunk.nll_head(m, r, self.head_table, onet.bin_size)

    def _head_recon(self, xs, pm):
        return trunk.nll_recon(xs, pm, self.net.out_net.bin_size).to(
            torch.uint8)
