"""QRes-VAE model zoo, counterpart of ``lvae_tpu/models/qresvae/zoo.py``:
qres34m with the MSE head, qres34m_lossless with the GaussianNLL pixel head,
and qres17m (CelebA, deconv upsamplers: legacy streams only)."""
import math

from lvae_tpu_torch.registry import register_model
from lvae_tpu_torch.models import common
from lvae_tpu_torch.models.qresvae.model import (
    GaussianNLLOutputNet, HierarchicalVAENet, MSEOutputNet, QLatentBlock,
    QresModel)

# ImageNet pixel stats
IMAGENET_SHIFT = -0.4546259594901961
IMAGENET_SCALE = 3.67572653978347
# CelebA pixel stats (qres17m; lvae_tpu/models/qresvae/zoo.py:148)
CELEBA_SHIFT = -0.4356
CELEBA_SCALE = 3.397893306150187


def _check_pretrained(pretrained):
    if pretrained is True:
        raise RuntimeError(
            'no QRes-VAE weights are bundled and nothing can be downloaded; '
            'pass pretrained=<local path> to a flax .msgpack weight file or '
            'a .pt / .pth checkpoint of the original PyTorch project')


def build(net, pretrained, device):
    """A QresModel of `net`, its weights initialised as the JAX package's
    flax modules initialise theirs (random) or read from a flax msgpack
    file of the JAX package or a .pt / .pth checkpoint of the original
    PyTorch project (`pretrained`: a local path)."""
    _check_pretrained(pretrained)
    common.flax_init_(net)
    model = QresModel(net, device=device)
    if pretrained:
        model.load_pretrained(pretrained)
    return model


def _qres34m_blocks(lossless):
    """qres34m's encoder and decoder blocks (lvae_tpu/models/qresvae/
    zoo.py:37-92): ch 96, 12 latent blocks at 1/64 .. 1/4 resolution with z
    dims 16/14/12/10/8; the MSE model ends in a patch_upsample to the
    pixels, the lossless one leaves the 1/4 feature to its head."""
    enc_nums = [6, 6, 6, 4, 2]
    dec_nums = [1, 2, 3, 3, 3]
    z_dims = [16, 14, 12, 10, 8]
    ch = 96
    B, D = common.MyConvNeXtBlock, common.MyConvNeXtPatchDown
    enc_blocks = [
        common.patch_downsample(3, ch * 2, rate=4),
        *[B(ch * 2, kernel_size=7) for _ in range(enc_nums[0])],
        D(ch * 2, ch * 4),
        *[B(ch * 4, kernel_size=7) for _ in range(enc_nums[1])],
        D(ch * 4, ch * 4),
        *[B(ch * 4, kernel_size=5) for _ in range(enc_nums[2])],
        D(ch * 4, ch * 4),
        *[B(ch * 4, kernel_size=3) for _ in range(enc_nums[3])],
        D(ch * 4, ch * 4),
        *[B(ch * 4, kernel_size=1) for _ in range(enc_nums[4])],
    ]
    # z_proj's last-conv init scaling: sqrt(N / 3), N the latent blocks
    rs = math.sqrt(sum(dec_nums) / 3)

    def latent(width, stage, ks):
        return [QLatentBlock(width, z_dims[stage], kernel_size=ks,
                             rescale_z=rs) for _ in range(dec_nums[stage])]

    dec_blocks = [
        *latent(ch * 4, 0, 1),
        common.patch_upsample(ch * 4, ch * 4, rate=2),
        *latent(ch * 4, 1, 3),
        common.patch_upsample(ch * 4, ch * 4, rate=2),
        *latent(ch * 4, 2, 5),
        common.patch_upsample(ch * 4, ch * 4, rate=2),
        *latent(ch * 4, 3, 7),
        common.patch_upsample(ch * 4, ch * 2, rate=2),
        *latent(ch * 2, 4, 7),
    ]
    if not lossless:
        dec_blocks.append(common.patch_upsample(ch * 2, 3, rate=4))
    return enc_blocks, dec_blocks, ch


@register_model
def qres34m(lmb=32, pretrained=False, device=None):
    """Fixed-rate QRes-VAE, ~34M parameters (lvae_tpu/models/qresvae/
    zoo.py:37-92), max stride 64."""
    _check_pretrained(pretrained)
    enc_blocks, dec_blocks, _ = _qres34m_blocks(lossless=False)
    net = HierarchicalVAENet(enc_blocks, dec_blocks, MSEOutputNet(lmb),
                             im_shift=IMAGENET_SHIFT, im_scale=IMAGENET_SCALE,
                             max_stride=64)
    return build(net, pretrained, device)


@register_model
def qres34m_lossless(pretrained=False, device=None):
    """Lossless QRes-VAE (lvae_tpu/models/qresvae/zoo.py:95-107): qres34m's
    blocks without the final upsample, and a GaussianNLL head whose two
    patch_upsample convs give each pixel's mean and scale."""
    _check_pretrained(pretrained)
    enc_blocks, dec_blocks, ch = _qres34m_blocks(lossless=True)
    out_net = GaussianNLLOutputNet(
        conv_mean=common.patch_upsample(ch * 2, 3, rate=4),
        conv_scale=common.patch_upsample(ch * 2, 3, rate=4))
    net = HierarchicalVAENet(enc_blocks, dec_blocks, out_net,
                             im_shift=IMAGENET_SHIFT, im_scale=IMAGENET_SCALE,
                             max_stride=64)
    return build(net, pretrained, device)


@register_model
def qres17m(lmb=8, pretrained=False, device=None):
    """The smaller QRes-VAE trained on CelebA (lvae_tpu/models/qresvae/
    zoo.py:111-150), max stride 64: widths 144/288, 12 latent blocks at
    1/64 .. 1/4 resolution with z dims 16/8/6/4 and kernel sizes 1/3/5/7,
    a nearest-neighbour x4 upsample and two transposed-conv upsamplers
    (common.deconv). The deconv has no portable kernel, so the model codes
    legacy streams (portable=False) only."""
    _check_pretrained(pretrained)
    enc_nums = [6, 6, 4, 2]
    dec_nums = [1, 2, 4, 5]
    z_dims = [16, 8, 6, 4]
    ch = 72
    B, D = common.MyConvNeXtBlock, common.MyConvNeXtPatchDown
    enc_blocks = [
        common.patch_downsample(3, ch * 2, rate=4),
        *[B(ch * 2, kernel_size=7) for _ in range(enc_nums[0])],
        D(ch * 2, ch * 4),
        *[B(ch * 4, kernel_size=5) for _ in range(enc_nums[1])],
        D(ch * 4, ch * 4),
        *[B(ch * 4, kernel_size=3) for _ in range(enc_nums[2])],
        D(ch * 4, ch * 4, down_rate=4),
        *[B(ch * 4, kernel_size=1) for _ in range(enc_nums[3])],
    ]
    rs = math.sqrt(sum(dec_nums) / 3)

    def latent(width, stage, ks):
        return [QLatentBlock(width, z_dims[stage], kernel_size=ks,
                             rescale_z=rs) for _ in range(dec_nums[stage])]

    dec_blocks = [
        *latent(ch * 4, 0, 1),
        common.upsample_nearest(rate=4),
        *latent(ch * 4, 1, 3),
        common.deconv(ch * 4, ch * 4, kernel_size=3),
        *latent(ch * 4, 2, 5),
        common.deconv(ch * 4, ch * 2),
        *latent(ch * 2, 3, 7),
        common.patch_upsample(ch * 2, 3, rate=4),
    ]
    net = HierarchicalVAENet(enc_blocks, dec_blocks, MSEOutputNet(lmb),
                             im_shift=CELEBA_SHIFT, im_scale=CELEBA_SCALE,
                             max_stride=64)
    return build(net, pretrained, device)
