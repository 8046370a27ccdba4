"""The fused QRes-VAE codec of ``lvae_tpu/models/qresvae/fused.py`` (MSE
head), for single images and batches, on either trunk
(models/fused_base.py holds the trunk loop both directions run, the payload
and batching).

QARV's construction without the lambda conditioning: the per-image context
is empty, the encoder features are keyed by their resolution (the last
block at each one wins), the trunk runs to the last latent block, and the
synthesis tail (the final patch_upsample) and the pixel finish run only on
decode and in the self-check.

* legacy (``FusedQresCodec``): the modules' library calls, NCHW.
* portable (``PortableQresCodec``): the plain ConvNeXt blocks, the VDBlock
  prior and its scale indexes, the z-projection junction, the 1x1 convs of
  the upsamplers and the pixel finish from the kernels of ``ops/trunk.py``.
"""
import torch

from lvae_tpu_torch.models import common
from lvae_tpu_torch.models.fused_base import FusedCodecBase, PortableTrunk
from lvae_tpu_torch.ops import cdf as cdf_ops
from lvae_tpu_torch.ops import trunk


class FusedQresCodec(FusedCodecBase):
    """Fused codec for HierarchicalVAENet with the MSE head, on the legacy
    trunk; PortableQresCodec overrides the trunk's stages."""

    def __init__(self, net, cdf_table, **cfg):
        if getattr(net.out_net, 'loss_name', None) != 'mse':
            raise NotImplementedError(
                'the lossless pixel head (the nll_head and nll_recon '
                'kernels) is the next slice of the port; this codec has the '
                'MSE head only')
        super().__init__(net, cdf_table, **cfg)
        blocks = list(net.dec_blocks)
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
        return self.net.encode_features(im)

    def _posterior(self, blk, f_mid, enc_features):
        return blk.posterior_qm(f_mid, enc_features[int(f_mid.shape[2])])


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
