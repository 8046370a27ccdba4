"""RD-model ablations, counterpart of ``lvae_tpu/models/rd/zoo_ablation.py``:
rd_model_base's skeleton at base widths 64, 96 and 128 (or its own), with
fewer latent blocks a stage, or without linear_sqrt companding
("nosmooth")."""
from lvae_tpu_torch.registry import register_model
from lvae_tpu_torch.models.rd.zoo import build_rd_model


def _dims(dim):
    enc_dims = [dim * 2, dim * 4, dim * 5, dim * 6, dim * 6]
    dec_dims = [dim * 6, dim * 6, dim * 5, dim * 4, dim * 2]
    return enc_dims, dec_dims


_Z = [32, 32, 32, 32, 32]
_ENC_NUMS = (6, 6, 6, 4, 4)


def _ablation(dims, dec_nums, smooth, lmb_range, pretrained, device):
    enc, dec = dims
    return build_rd_model(enc, dec, _Z, _ENC_NUMS, dec_nums, lmb_range,
                          use_linear_sqrt=smooth, pretrained=pretrained,
                          device=device)


@register_model
def rd_ablation_c64_l5_nosmooth(lmb_range=(4, 2048), pretrained=False,
                                device=None):
    return _ablation(_dims(64), (1, 1, 1, 1, 1), False, lmb_range,
                     pretrained, device)


@register_model
def rd_ablation_c64_l5(lmb_range=(4, 2048), pretrained=False, device=None):
    return _ablation(_dims(64), (1, 1, 1, 1, 1), True, lmb_range,
                     pretrained, device)


@register_model
def rd_ablation_c64_l10(lmb_range=(4, 2048), pretrained=False, device=None):
    return _ablation(_dims(64), (1, 2, 2, 2, 3), True, lmb_range,
                     pretrained, device)


@register_model
def rd_ablation_c64_l15(lmb_range=(4, 2048), pretrained=False, device=None):
    return _ablation(_dims(64), (1, 2, 3, 4, 5), True, lmb_range,
                     pretrained, device)


@register_model
def rd_ablation_c96_l15(lmb_range=(4, 2048), pretrained=False, device=None):
    return _ablation(_dims(96), (1, 2, 3, 4, 5), True, lmb_range,
                     pretrained, device)


@register_model
def rd_ablation_c128_l10(lmb_range=(4, 2048), pretrained=False,
                         device=None):
    return _ablation(_dims(128), (1, 1, 2, 3, 3), True, lmb_range,
                     pretrained, device)


@register_model
def rd_ablation_base_nosmooth(lmb_range=(4, 2048), pretrained=False,
                              device=None):
    return _ablation(([256, 512, 640, 768, 768], [768, 768, 640, 512, 256]),
                     (1, 2, 3, 4, 5), False, lmb_range, pretrained, device)
