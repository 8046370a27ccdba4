"""Tiny development models for the tests, counterparts of qarv_tiny,
qres_tiny, qres_tiny_lossless and rd_tiny in ``lvae_tpu/models/dev_zoo.py``:
the production topologies at 16 channels."""
from lvae_tpu_torch.registry import register_model
from lvae_tpu_torch.models import common
from lvae_tpu_torch.models.qarv import model as qarv
from lvae_tpu_torch.models.qresvae import model as qres
from lvae_tpu_torch.models.qresvae import zoo as qres_zoo
from lvae_tpu_torch.models.rd import model as rd


@register_model
def qarv_tiny(lmb_range=(16, 2048), device=None):
    ch = 16
    ed = 32

    def rb(dim, ks=3):
        return common.ConvNeXtBlockAdaLN(dim, ed, kernel_size=ks)

    enc_blocks = [
        common.patch_downsample(3, ch, rate=4),        # 1/4
        rb(ch, 7),
        common.patch_downsample(ch, ch, rate=4),       # 1/16
        rb(ch, 3),
        common.SetKey('enc_s16'),
        common.patch_downsample(ch, ch, rate=4),       # 1/64
        rb(ch, 1),
        common.SetKey('enc_s64'),
    ]
    dec_blocks = [
        qarv.VRLVBlockBase(ch, 4, enc_key='enc_s64', enc_width=ch,
                           embed_dim=ed, kernel_size=1),
        common.patch_upsample(ch, ch, rate=4),
        qarv.VRLVBlockSmall(ch, 4, enc_key='enc_s16', enc_width=ch,
                            embed_dim=ed, kernel_size=3),
        common.CompressionStopFlag(),
        rb(ch, 3),
        common.patch_upsample(ch, ch, rate=4),
        rb(ch, 7),
        common.patch_upsample(ch, 3, rate=4),
    ]
    net = qarv.VariableRateLossyVAENet(
        enc_blocks, dec_blocks, im_shift=-0.45, im_scale=3.67, max_stride=64,
        lmb_range=(float(lmb_range[0]), float(lmb_range[1])),
        lmb_embed_dim=(ed, ed), sin_period=64)
    return qarv.QarvModel(net, device=device)


@register_model
def qres_tiny(lmb=32, lossless=False, device=None):
    ch = 16
    z = [4, 4, 4]
    enc_blocks = [
        common.patch_downsample(3, ch, rate=4),                  # 1/4
        common.MyConvNeXtBlock(ch, kernel_size=7),
        common.MyConvNeXtPatchDown(ch, ch, down_rate=4),         # 1/16
        common.MyConvNeXtBlock(ch, kernel_size=3),
        common.MyConvNeXtPatchDown(ch, ch, down_rate=4),         # 1/64
        common.MyConvNeXtBlock(ch, kernel_size=1),
    ]
    dec_blocks = [
        qres.QLatentBlock(ch, z[0], kernel_size=1),              # 1/64
        common.patch_upsample(ch, ch, rate=4),
        qres.QLatentBlock(ch, z[1], kernel_size=3),              # 1/16
        common.patch_upsample(ch, ch, rate=4),
        qres.QLatentBlock(ch, z[2], kernel_size=7),              # 1/4
    ]
    if lossless:
        out_net = qres.GaussianNLLOutputNet(
            conv_mean=common.patch_upsample(ch, 3, rate=4),
            conv_scale=common.patch_upsample(ch, 3, rate=4))
    else:
        dec_blocks.append(common.patch_upsample(ch, 3, rate=4))
        out_net = qres.MSEOutputNet(lmb)
    net = qres.HierarchicalVAENet(
        enc_blocks, dec_blocks, out_net, im_shift=-0.45, im_scale=3.67,
        max_stride=64)
    return qres_zoo.build(net, False, device)


@register_model
def qres_tiny_lossless(device=None):
    return qres_tiny(lossless=True, device=device)


@register_model
def rd_tiny(lmb_range=(4, 2048), device=None):
    ch = 16
    ed = 32

    def rb(dim):
        return common.ConvNeXtBlockAdaLN(dim, ed, kernel_size=3)

    enc_blocks = [
        common.patch_downsample(3, ch, rate=4),
        rb(ch),
        rd.ConvNeXtAdaLNPatchDown(ch, ch, down_rate=4, embed_dim=ed),
        rb(ch),
        rd.ConvNeXtAdaLNPatchDown(ch, ch, down_rate=4, embed_dim=ed),
        rb(ch),
    ]
    dec_blocks = [
        rd.LatentVariableBlock(ch, 4, ed, enc_width=ch, kernel_size=1),
        common.patch_upsample(ch, ch, rate=4),
        rd.LatentVariableBlock(ch, 4, ed, enc_width=ch, kernel_size=3),
        common.patch_upsample(ch, ch, rate=4),
        rd.LatentVariableBlock(ch, 4, ed, enc_width=ch, kernel_size=3),
        common.patch_upsample(ch, 3, rate=4),
    ]
    net = rd.RDVAENet(
        enc_blocks, dec_blocks, im_shift=-0.45, im_scale=3.67, max_stride=64,
        lmb_range=(float(lmb_range[0]), float(lmb_range[1])),
        lmb_embed_dim=(ed, ed), sin_period=64)
    return rd.RDModel(net, device=device)
