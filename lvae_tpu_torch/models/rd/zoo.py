"""RD-model zoo, counterpart of ``lvae_tpu/models/rd/zoo.py``."""
from lvae_tpu_torch.registry import register_model
from lvae_tpu_torch.models import common
from lvae_tpu_torch.models.rd.model import (ConvNeXtAdaLNPatchDown,
                                            LatentVariableBlock, RDModel,
                                            RDVAENet)

# ImageNet pixel stats
IMAGENET_SHIFT = -0.4546259594901961
IMAGENET_SCALE = 3.67572653978347


def build_rd_model(enc_dims, dec_dims, z_dims, enc_nums=(6, 6, 6, 4, 4),
                   dec_nums=(1, 2, 3, 4, 5), lmb_range=(4, 2048),
                   use_linear_sqrt=True, ed=256, pretrained=False,
                   device=None):
    """The RD model: a 1/4 patch downsample, then AdaLN ConvNeXt stages
    down to 1/64 (enc_nums blocks a stage); latent blocks up from 1/64
    (dec_nums a stage, z_dims channels), patch upsamples between them and
    to the pixels. Its weights are drawn as the JAX package's flax modules
    draw theirs (common.flax_init_, from torch's global generator), or read
    from `pretrained`: a flax .msgpack file of the JAX package, or a .pt /
    .pth checkpoint of the original PyTorch project (models/port.py)."""
    if pretrained is True:
        raise RuntimeError('no RD-model weights are bundled and nothing can '
                           'be downloaded; pass pretrained=<local path>')

    def rb(dim):
        return common.ConvNeXtBlockAdaLN(dim, ed)

    def down(a, b):
        return ConvNeXtAdaLNPatchDown(a, b, embed_dim=ed)

    enc_blocks = [
        common.patch_downsample(3, enc_dims[0], rate=4),
        *[rb(enc_dims[0]) for _ in range(enc_nums[0])],
        down(enc_dims[0], enc_dims[1]),
        *[rb(enc_dims[1]) for _ in range(enc_nums[1])],
        down(enc_dims[1], enc_dims[2]),
        *[rb(enc_dims[2]) for _ in range(enc_nums[2])],
        down(enc_dims[2], enc_dims[3]),
        *[rb(enc_dims[3]) for _ in range(enc_nums[3])],
        down(enc_dims[3], enc_dims[3]),
        *[rb(enc_dims[3]) for _ in range(enc_nums[4])],
    ]
    dec_blocks = []
    for i in range(5):
        # stage i at 1/64 * 2^i: its latent blocks read the encoder feature
        # of that height, whose width is enc_dims[-1 - i]
        dec_blocks += [LatentVariableBlock(dec_dims[i], z_dims[i], ed,
                                           enc_width=enc_dims[-1 - i],
                                           use_linear_sqrt=use_linear_sqrt)
                       for _ in range(dec_nums[i])]
        dec_blocks.append(
            common.patch_upsample(dec_dims[i], dec_dims[i + 1], rate=2)
            if i < 4 else common.patch_upsample(dec_dims[i], 3, rate=4))
    net = RDVAENet(
        enc_blocks, dec_blocks, im_shift=IMAGENET_SHIFT,
        im_scale=IMAGENET_SCALE, max_stride=64,
        lmb_range=(float(lmb_range[0]), float(lmb_range[1])),
        lmb_embed_dim=(256, 256), sin_period=64)
    common.flax_init_(net)
    model = RDModel(net, device=device)
    if pretrained:
        model.load_pretrained(pretrained)
    return model


@register_model
def rd_model_base(lmb_range=(4, 2048), pretrained=False, device=None):
    """15 latent blocks, ~187M parameters."""
    return build_rd_model(
        enc_dims=[256, 512, 640, 768, 768],
        dec_dims=[768, 768, 640, 512, 256],
        z_dims=[32, 32, 32, 32, 32],
        enc_nums=(6, 6, 6, 4, 4), dec_nums=(1, 2, 3, 4, 5),
        lmb_range=lmb_range, pretrained=pretrained, device=device)
