"""The fused QARV codec of ``lvae_tpu/models/qarv/fused.py``, for single
images and batches, on either trunk (models/fused_base.py holds the trunk
loop both directions run and the payload).

Encode: lambda embedding -> encoder backbone -> per latent block prior ->
symbols = round(posterior mean - prior mean) -> fuse, with the plain blocks
in between -> escapes, row layout and the CUDA rANS encode kernel -> one
payload pull. Decode: the same trunk with the symbols from the CUDA rANS
decode kernel, then the synthesis tail and clip*0.5+0.5 -> float16.

The trunk runs B images at once, each with its own lambda (the per-image
context of the entry points). A single image goes through the single-image
rANS kernels; a batch (chunk) through the multi-image ones: one encode
launch, and one decode launch per latent block.

* legacy (``FusedQarvCodec``): the modules' library calls, NCHW; LayerNorm
  has eps 1e-6 and no affine (models/common.py).
* portable (``PortableQarvCodec``): the lambda embedding, ConvNeXt-AdaLN
  blocks, priors and scale indexes, fuses, 1x1 convs and the pixel finish
  from the kernels of ``ops/trunk.py``.
"""
import torch

from lvae_tpu_torch.models import common
from lvae_tpu_torch.models.base import cpu_lowp_convs
from lvae_tpu_torch.models.fused_base import FusedCodecBase, PortableTrunk
from lvae_tpu_torch.ops import cdf as cdf_ops
from lvae_tpu_torch.ops import trunk


class FusedQarvCodec(FusedCodecBase):
    """Fused codec for VariableRateLossyVAENet (lambda-conditioned) on the
    legacy trunk; PortableQarvCodec overrides the trunk's stages."""

    supports_portable = True

    def __init__(self, net, cdf_table, **cfg):
        super().__init__(net, cdf_table, **cfg)
        blocks = list(net.dec_blocks)
        self.stop = next(i for i, b in enumerate(blocks)
                         if isinstance(b, common.CompressionStopFlag))
        self.tail_start = self.stop + 1

    # ---- the trunk's stages; context (emb, gemb) ------------------------

    def _context(self, lmb):
        """lmb (B,) -> (emb for the backbone and posterior, gelu(emb) or
        None)."""
        return self.net.get_lmb_embedding(lmb), None

    def _prior(self, blk, feature, emb, gemb):
        """-> (f_mid, pm float32, scale indexes int32), in this layout."""
        f_mid, pm, _, indexes = blk.prior_stage(feature, emb)
        return f_mid, pm, indexes

    def _fuse(self, blk, f_mid, pm, syms, emb, gemb):
        return blk.fuse_stage(f_mid, pm, syms, emb)

    def _plain(self, blk, feature, emb, gemb):
        return (blk(feature, emb) if getattr(blk, 'requires_embedding', False)
                else blk(feature))

    def _backbone(self, im, emb, gemb):
        cd = self.compute_dtype
        if cd is None:
            return self.net.encode_features(im, emb)
        # the image and the embedding enter in bf16; each feature leaves as
        # float32 (lvae_tpu/models/qarv/fused.py:222-241)
        with cpu_lowp_convs(im.device):
            feats = self.net.encode_features(im.to(cd), emb.to(cd),
                                             blocks=self.backbone_blocks())
        return {k: v.float() for k, v in feats.items()}

    def _posterior(self, blk, f_mid, enc_features, emb, gemb):
        return blk.posterior_qm(f_mid, enc_features[blk.enc_key], emb)


class PortableQarvCodec(PortableTrunk, FusedQarvCodec):
    """The fused codec on the portable trunk: every float between the
    integer junctions from the kernels of ops/trunk.py, on NHWC features
    (lvae_tpu/models/qarv/fused.py:99-193)."""

    def __init__(self, net, cdf_table, **cfg):
        super().__init__(net, cdf_table, **cfg)
        self.table = torch.as_tensor(
            cdf_ops.default_gaussian_scale_table().astype('float32'),
            device=self.device)
        self.freqs = torch.as_tensor(
            trunk.emb_freqs(net.lmb_embed_dim[0], net.sin_period),
            device=self.device)

    def _context(self, lmb):
        net = self.net
        e0, e1 = net.lmb_embed_0, net.lmb_embed_1
        return trunk.emb_mlp(lmb, self.freqs, e0.weight.t(), e0.bias,
                             e1.weight.t(), e1.bias, net.sin_period)

    def _prior(self, blk, feature, emb, gemb):
        f_mid = trunk.convnext_adaln(feature, blk.resnet_front, gemb)
        B, H, W, C = f_mid.shape
        Z = blk.zdim
        pm, idx = trunk.prior_head(
            f_mid.reshape(B, H * W, C), blk.prior.weight.reshape(2 * Z, C).t(),
            blk.prior.bias, self.table)
        return f_mid, pm.reshape(B, H, W, Z), idx.reshape(B, H, W, Z)

    def _fuse(self, blk, f_mid, pm, syms, emb, gemb):
        B, H, W, C = f_mid.shape
        Z = blk.zdim
        f2 = trunk.fuse_zproj(
            f_mid.reshape(B, H * W, C), syms.reshape(B, H * W, Z),
            pm.reshape(B, H * W, Z), blk.z_proj.weight.reshape(C, Z).t(),
            blk.z_proj.bias).reshape(B, H, W, C)
        return trunk.convnext_adaln(f2, blk.resnet_end, gemb)

    def _plain(self, blk, feature, emb, gemb):
        if isinstance(blk, common.ConvNeXtBlockAdaLN):
            return trunk.convnext_adaln(feature, blk, gemb)
        return super()._plain(blk, feature, emb, gemb)
