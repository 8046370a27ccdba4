"""Weights from the original PyTorch project's checkpoints, counterpart of
``lvae_tpu/models/port.py``.

The original project's state dicts (its qres34m / qres17m / qarv_base /
rd_model_base checkpoints) name parameters by its own module tree; this
module maps them onto the port's. The JAX package converts each tensor to
flax layout (``t_conv``, ``t_dense``, ``t_convT``, ``t_flat``,
``t_bias_nhwc``) and ``models/weights.params_from_flax`` converts flax
layout back to the port's, so the port's transform is the composition of
the two:

  conv, depthwise conv   (O, I, kh, kw) -> HWIO -> (O, I, kh, kw): the same
  Linear                 (out, in) -> (in, out) -> (out, in): the same
  ConvTranspose2d        (I, O, kh, kw) -> flipped HWIO -> flipped back:
                         the same
  decoder bias           (1, C, 1, 1) -> NHWC -> (1, C, 1, 1): the same
  LayerNorm weight/bias  unchanged both ways
  layer scale gamma      flattened by t_flat, kept flat: (C,)

So every tensor is taken as it is, float32, and only gamma is flattened.
The names follow the original module code, including its 'downsapmle'
spelling, the AdaLN embedding's Sequential index (embedding_layer.1) and
QRes's z_proj.0 / z_proj.2.
"""
import torch

from lvae_tpu_torch.models import common
from lvae_tpu_torch.models.qarv import model as qarv
from lvae_tpu_torch.models.qresvae import model as qres
from lvae_tpu_torch.models.rd import model as rd


def t_same(w):
    return w


def t_flat(w):
    return w.reshape(-1)


# ----------------------------------------------------- per-module key rules
# (our state-dict key, the original key, transform), prefixes without the
# trailing dot

def _conv_rules(ours, tk):
    return [(ours + '.weight', tk + '.weight', t_same),
            (ours + '.bias', tk + '.bias', t_same)]


_dense_rules = _conv_rules


def _myconvnext_rules(ours, tk):
    """MyConvNeXtBlock <-> the original's timm-style ConvNeXt block."""
    return (_conv_rules(ours + '.conv_dw', tk + '.conv_dw')
            + [(ours + '.norm.weight', tk + '.norm.weight', t_same),
               (ours + '.norm.bias', tk + '.norm.bias', t_same)]
            + _dense_rules(ours + '.mlp.fc1', tk + '.mlp.fc1')
            + _dense_rules(ours + '.mlp.fc2', tk + '.mlp.fc2')
            + [(ours + '.gamma', tk + '.gamma', t_flat)])


def _adaln_rules(ours, tk):
    """ConvNeXtBlockAdaLN: a norm without affine; the embedding layer is
    the original's Sequential(GELU, Linear, Unflatten), so index 1."""
    return (_conv_rules(ours + '.conv_dw', tk + '.conv_dw')
            + _dense_rules(ours + '.embedding_layer',
                           tk + '.embedding_layer.1')
            + _dense_rules(ours + '.mlp.fc1', tk + '.mlp.fc1')
            + _dense_rules(ours + '.mlp.fc2', tk + '.mlp.fc2')
            + [(ours + '.gamma', tk + '.gamma', t_flat)])


def _vdblock_rules(ours, tk):
    out = []
    for c in ('c1', 'c2', 'c3', 'c4'):
        out += _conv_rules(f'{ours}.{c}', f'{tk}.{c}')
    return out


def _sub(ours, tk, rule, *names):
    out = []
    for n in names:
        out += rule(f'{ours}.{n}', f'{tk}.{n}')
    return out


def block_rules(block, ours, tk):
    """The rules of one block of the port (`ours`: its state-dict prefix)
    whose original prefix is `tk`."""
    if isinstance(block, common.patch_downsample):
        return _conv_rules(ours + '.conv', tk)
    if isinstance(block, common.patch_upsample):
        return _conv_rules(ours + '.conv', tk + '.0')
    if isinstance(block, common.deconv):
        return _conv_rules(ours + '.conv', tk)
    if isinstance(block, (common.upsample_nearest, common.SetKey,
                          common.CompressionStopFlag)):
        return []
    if isinstance(block, common.MyConvNeXtPatchDown):
        return (_myconvnext_rules(ours + '.block', tk)
                + _conv_rules(ours + '.downsample.conv', tk + '.downsapmle'))
    if isinstance(block, common.MyConvNeXtBlock):
        return _myconvnext_rules(ours, tk)
    if isinstance(block, rd.ConvNeXtAdaLNPatchDown):
        return (_adaln_rules(ours + '.block', tk)
                + _conv_rules(ours + '.downsample.conv', tk + '.downsapmle'))
    if isinstance(block, common.ConvNeXtBlockAdaLN):
        return _adaln_rules(ours, tk)
    if isinstance(block, qres.QLatentBlock):
        return (_sub(ours, tk, _myconvnext_rules, 'resnet_front',
                     'resnet_end')
                + _sub(ours, tk, _vdblock_rules, 'posterior', 'prior')
                + _conv_rules(ours + '.z_proj_0', tk + '.z_proj.0')
                + _conv_rules(ours + '.z_proj_1', tk + '.z_proj.2'))
    convs = ('post_merge', 'posterior', 'z_proj', 'prior')
    if isinstance(block, qarv.VRLVBlockSmall):
        return (_sub(ours, tk, _adaln_rules, 'resnet_front', 'resnet_end',
                     'posterior2')
                + _sub(ours, tk, _conv_rules, *convs))
    if isinstance(block, (qarv.VRLVBlockBase, rd.LatentVariableBlock)):
        return (_sub(ours, tk, _adaln_rules, 'resnet_front', 'resnet_end',
                     'posterior0', 'posterior1', 'posterior2')
                + _sub(ours, tk, _conv_rules, *convs))
    raise NotImplementedError(f'no porting rules for {type(block).__name__}')


def build_key_map(model):
    """[(our state-dict key, original key, transform)] covering the net."""
    net = model.net
    rules = []
    if isinstance(net, qres.HierarchicalVAENet):
        enc_t, dec_t = 'encoder.enc_blocks.{}', 'decoder.dec_blocks.{}'
        rules.append(('bias', 'decoder.bias', t_same))
        if isinstance(net.out_net, qres.GaussianNLLOutputNet):
            for head in ('conv_mean', 'conv_scale'):
                rules += _conv_rules(f'out_net.{head}.conv',
                                     f'out_net.{head}.0')
    elif isinstance(net, (qarv.VariableRateLossyVAENet, rd.RDVAENet)):
        enc_t, dec_t = 'encoder.enc_blocks.{}', 'dec_blocks.{}'
        rules.append(('bias', 'bias', t_same))
        rules += _dense_rules('lmb_embed_0', 'lmb_embedding.0')
        rules += _dense_rules('lmb_embed_1', 'lmb_embedding.2')
    else:
        raise NotImplementedError(type(net).__name__)
    for i, b in enumerate(net.enc_blocks):
        rules += block_rules(b, f'enc_blocks.{i}', enc_t.format(i))
    for i, b in enumerate(net.dec_blocks):
        rules += block_rules(b, f'dec_blocks.{i}', dec_t.format(i))
    return rules


def convert_state_dict(model, torch_sd):
    """{original key: tensor or array} -> the port's state dict (float32 CPU
    tensors) for `model`'s net. Keys the net does not use are ignored.
    Raises KeyError for an original key missing or a parameter no rule
    covers, ValueError for a shape mismatch, as the JAX loader does."""
    by_key = {ours: (tk, fn) for ours, tk, fn in build_key_map(model)}
    sd, missing = {}, []
    for key, param in model.net.state_dict().items():
        if key not in by_key:
            missing.append(key)
            continue
        tk, fn = by_key[key]
        if tk not in torch_sd:
            raise KeyError(f'torch checkpoint missing key {tk} '
                           f'(for parameter {key})')
        t = fn(torch.as_tensor(torch_sd[tk]).detach().cpu().to(
            torch.float32))
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f'shape mismatch for {key} <- {tk}: '
                             f'{tuple(t.shape)} vs {tuple(param.shape)}')
        sd[key] = t.contiguous()
    if missing:
        raise KeyError(f'no porting rule covers parameters: {missing[:10]}'
                       f'{"..." if len(missing) > 10 else ""}')
    return sd


def load_torch_checkpoint(model, path):
    """Read an original-project .pt / .pth file (tensors only:
    weights_only=True; the state dict under a 'model' key when there is
    one, beside optimizer state) and convert it (convert_state_dict);
    float16 tensors come back float32, extra buffers (CompressAI's
    _quantized_cdf, ...) are ignored."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    sd = ckpt.get('model', ckpt) if isinstance(ckpt, dict) else ckpt
    return convert_state_dict(model, {k: v for k, v in sd.items()
                                      if torch.is_tensor(v)})
