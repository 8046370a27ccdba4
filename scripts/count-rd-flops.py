#!/usr/bin/env python3
"""Count the floating-point operations of one RD-model forward (the
training forward RDModel.forward runs: encoder, every latent block's prior,
posterior and z projection, the synthesis) with torch's FlopCounterMode on
the meta device: shapes only, nothing allocated or computed, so it runs on
any machine in seconds. Convolutions and products count 2 per
multiply-add; LayerNorms, activations and the KL's elementwise math are
not counted. Prints one JSON object: the total, the encoder's and the
decoder's (latent blocks and upsamplers), and the least time at the given
rate (default 67e12 operations/s: the H100 SXM's float32 rate outside the
tensor cores, which exact float32 convolutions run at).

    python3 scripts/count-rd-flops.py [--model rd_model_base] \
        [--hw 512 768] [--rate 67e12]
"""
import argparse
import json
import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def count(model_name, hw):
    import lvae_tpu_torch
    with torch.device('meta'):
        model = lvae_tpu_torch.get_model(model_name, device='meta')
    net = model.net.requires_grad_(False)
    im = torch.zeros(1, 3, *hw, device='meta')
    lmb = torch.full((1,), 64.0, device='meta')
    emb = net.get_lmb_embedding(lmb)
    with FlopCounterMode(display=False) as enc:
        x = (im + net.im_shift) * net.im_scale
        feats = net.encode(x, emb)
    with FlopCounterMode(display=False) as total:
        net.forward_end2end(im, lmb)
    return dict(model=model_name, hw=list(hw), params=model.num_params(),
                flops=total.get_total_flops(),
                encoder_flops=enc.get_total_flops(),
                decoder_flops=total.get_total_flops() - enc.get_total_flops(),
                latent_grid=[int(v.shape[2]) for v in feats.values()])


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--model', default='rd_model_base')
    p.add_argument('--hw', type=int, nargs=2, default=[512, 768])
    p.add_argument('--rate', type=float, default=67e12)
    args = p.parse_args()
    out = count(args.model, tuple(args.hw))
    out['rate'] = args.rate
    out['bound_ms'] = out['flops'] / args.rate * 1e3
    print(json.dumps(out))


if __name__ == '__main__':
    main()
