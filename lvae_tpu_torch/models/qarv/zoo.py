"""QARV model zoo, counterpart of ``lvae_tpu/models/qarv/zoo.py``."""
from lvae_tpu_torch.registry import register_model
from lvae_tpu_torch.models import common
from lvae_tpu_torch.models.qarv.model import (
    QarvModel, VariableRateLossyVAENet, VRLVBlockBase)


@register_model
def qarv_base(lmb_range=(16, 2048), pretrained=False, device=None):
    """Continuously variable-rate codec with 9 latent blocks. pretrained:
    False (random init), the path of a flax msgpack weight file of the JAX
    package, or of a .pt / .pth checkpoint of the original PyTorch
    project."""
    # ImageNet pixel stats
    im_shift = -0.4546259594901961
    im_scale = 3.67572653978347
    lmb_embed_dim = (256, 256)
    ed = lmb_embed_dim[1]
    ch = 128
    enc_dims = [192, ch * 3, ch * 4, ch * 4, ch * 4]

    def rb(dim, kernel_size=7, mlp_ratio=2):
        return common.ConvNeXtBlockAdaLN(dim, ed, kernel_size=kernel_size,
                                         mlp_ratio=mlp_ratio)

    enc_blocks = [
        # input -> 1/4 resolution
        common.patch_downsample(3, enc_dims[0], rate=4),
        *[rb(enc_dims[0], kernel_size=7) for _ in range(6)],
        rb(enc_dims[0]),
        common.patch_downsample(enc_dims[0], enc_dims[1]),
        # 1/8
        *[rb(enc_dims[1], kernel_size=7) for _ in range(6)],
        common.SetKey('enc_s8'),
        rb(enc_dims[1]),
        common.patch_downsample(enc_dims[1], enc_dims[2]),
        # 1/16
        *[rb(enc_dims[2], kernel_size=5) for _ in range(6)],
        common.SetKey('enc_s16'),
        rb(enc_dims[2]),
        common.patch_downsample(enc_dims[2], enc_dims[3]),
        # 1/32
        *[rb(enc_dims[3], kernel_size=3) for _ in range(4)],
        common.SetKey('enc_s32'),
        rb(enc_dims[3]),
        common.patch_downsample(enc_dims[3], enc_dims[4]),
        # 1/64
        *[rb(enc_dims[4], kernel_size=1) for _ in range(4)],
        common.SetKey('enc_s64'),
    ]

    dec_dims = [ch * 4, ch * 4, ch * 3, ch * 2, ch * 1]
    z_dims = [32, 32, 96, 8]

    dec_blocks = [
        # 1/64
        *[VRLVBlockBase(dec_dims[0], z_dims[0], enc_key='enc_s64',
                        enc_width=enc_dims[-1], embed_dim=ed,
                        kernel_size=1, mlp_ratio=4) for _ in range(1)],
        rb(dec_dims[0], kernel_size=1, mlp_ratio=4),
        common.patch_upsample(dec_dims[0], dec_dims[1], rate=2),
        # 1/32
        rb(dec_dims[1], kernel_size=3, mlp_ratio=3),
        *[VRLVBlockBase(dec_dims[1], z_dims[1], enc_key='enc_s32',
                        enc_width=enc_dims[-2], embed_dim=ed,
                        kernel_size=3, mlp_ratio=3) for _ in range(2)],
        rb(dec_dims[1], kernel_size=3, mlp_ratio=3),
        common.patch_upsample(dec_dims[1], dec_dims[2], rate=2),
        # 1/16
        rb(dec_dims[2], kernel_size=5, mlp_ratio=2),
        *[VRLVBlockBase(dec_dims[2], z_dims[2], enc_key='enc_s16',
                        enc_width=enc_dims[-3], embed_dim=ed,
                        kernel_size=5, mlp_ratio=2) for _ in range(3)],
        rb(dec_dims[2], kernel_size=5, mlp_ratio=2),
        common.patch_upsample(dec_dims[2], dec_dims[3], rate=2),
        # 1/8
        rb(dec_dims[3], kernel_size=7, mlp_ratio=1.75),
        *[VRLVBlockBase(dec_dims[3], z_dims[3], enc_key='enc_s8',
                        enc_width=enc_dims[-4], embed_dim=ed,
                        kernel_size=7, mlp_ratio=1.75) for _ in range(3)],
        # encode-side early stop: everything below only synthesizes pixels
        common.CompressionStopFlag(),
        rb(dec_dims[3], kernel_size=7, mlp_ratio=1.75),
        common.patch_upsample(dec_dims[3], dec_dims[4], rate=2),
        # 1/4
        *[rb(dec_dims[4], kernel_size=7, mlp_ratio=1.5) for _ in range(8)],
        common.patch_upsample(dec_dims[4], 3, rate=4),
    ]

    net = VariableRateLossyVAENet(
        enc_blocks, dec_blocks, im_shift=im_shift, im_scale=im_scale,
        max_stride=64, lmb_range=(float(lmb_range[0]), float(lmb_range[1])),
        lmb_embed_dim=lmb_embed_dim, sin_period=64)
    model = QarvModel(net, device=device,
                      log_images=['collie64.png', 'gun128.png',
                                  'motor256.png'])
    if pretrained is True:
        raise RuntimeError('nothing can be downloaded; pass '
                           'pretrained=<local path>')
    if pretrained:
        model.load_pretrained(pretrained)
    return model
