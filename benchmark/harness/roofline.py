"""The yardstick's arithmetic: the card's peaks, each trunk computation's
operations and bytes (each input read once, each output written once), the
trunk's least time for a request, and the operations of a whole encode,
decode or training step counted on the plain reference.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM3 and 67 TFLOP/s in
float32 outside the tensor cores; the configurations compute in exact
float32 with TF32 off."""
import math

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# operations of one GELU (the erf polynomial: |x|, the reciprocal, ten
# multiply-adds, the exponential's argument and the outer 0.5 * x * (1 + .))
GELU_OPS = 20


def work(name, args):
    """(bytes the computation must move, operations it does) for one call
    of the trunk function `name` on tensors shaped as `args` (meta tensors
    will do): each input read once, each output written once."""
    def n(a):
        return a.numel()

    if name == 'emb_mlp':
        lmb, freqs, w0, b0, w1, b1, _ = args
        B, (E0, E) = n(lmb), w0.shape
        return (4 * (B + n(freqs) + n(w0) + n(b0) + n(w1) + n(b1) + 2 * B * E),
                2 * B * (E0 * E + E * E))
    if name == 'dw_ln_mod':
        x, dwk, dwb, ew, eb, gemb, K = args
        B, H, W, C = x.shape
        return (4 * (2 * n(x) + n(dwk) + n(dwb) + n(ew) + n(eb) + n(gemb)),
                n(x) * (2 * K * K + 8) + 2 * n(gemb) * 2 * C)
    if name == 'dw_ln_affine':
        x, dwk, dwb, scale, bias, K = args
        return (4 * (2 * n(x) + n(dwk) + n(dwb) + n(scale) + n(bias)),
                n(x) * (2 * K * K + 8))
    if name == 'mlp_res':
        t, w1, b1, w2, b2, g, s = args
        M = t.shape[0] * t.shape[1]
        return (4 * (n(t) + 2 * n(s) + n(w1) + n(b1) + n(w2) + n(b2) + n(g)),
                2 * M * (n(w1) + n(w2)))
    if name == 'dense':
        x, w, b = args
        M = x.shape[0] * x.shape[1]
        return 4 * (n(x) + M * w.shape[1] + n(w) + n(b)), 2 * M * n(w)
    if name == 'prior_head':
        # the index of a scale in the ascending table needs ~log2(S)
        # compares
        x, w, b, table = args[:4]
        M, Z = x.shape[0] * x.shape[1], w.shape[1] // 2
        return (4 * (n(x) + n(w) + n(b) + n(table) + 2 * M * Z),
                2 * M * n(w) + M * Z * math.ceil(math.log2(n(table))))
    if name == 'fuse_zproj':
        f, syms, pm, w, b = args
        M = f.shape[0] * f.shape[1]
        return (4 * (2 * n(f) + n(syms) + n(pm) + n(w) + n(b)),
                2 * M * n(w))
    if name == 'upsample_finish':
        # the product's operations; the feature and the weights read once,
        # the float16 pixels written once
        x, w, b = args[:3]
        M = x.shape[0] * x.shape[1] * x.shape[2]
        return (4 * (n(x) + n(w) + n(b)) + 2 * M * w.shape[1],
                2 * M * n(w))
    if name == 'dense_act':
        x, w, b = args[:3]
        M = x.shape[0] * x.shape[1]
        return (4 * (n(x) + M * w.shape[1] + n(w) + n(b)),
                2 * M * n(w) + GELU_OPS * n(x))
    if name == 'conv_kxk_act':
        x, wk, b = args[:3]
        M = x.shape[0] * x.shape[1] * x.shape[2]
        return (4 * (n(x) + M * wk.shape[-1] + n(wk) + n(b)),
                2 * M * n(wk) + GELU_OPS * n(x))
    if name == 'zadd_dense':
        syms, pm, w, b = args
        M = syms.shape[0] * syms.shape[1]
        return (4 * (n(syms) + n(pm) + M * w.shape[1] + n(w) + n(b)),
                2 * M * n(w) + n(pm))
    if name == 'zadd_conv_kxk':
        syms, pm, wk, b = args
        M = syms.shape[0] * syms.shape[1] * syms.shape[2]
        return (4 * (n(syms) + n(pm) + M * wk.shape[-1] + n(wk) + n(b)),
                2 * M * n(wk) + n(pm))
    if name == 'res_dense_act':
        f, t, w, b = args
        M = f.shape[0] * f.shape[1]
        return (4 * (2 * n(f) + n(t) + n(w) + n(b)),
                2 * M * n(w) + GELU_OPS * n(t) + 2 * n(f))
    raise KeyError(name)


def _m(*shape):
    return torch.empty(shape, device='meta')


def trunk_calls(net, direction, B, H, W):
    """The portable trunk's computations for one request of B images of
    H x W, as (name, args) with meta tensors: the lambda embedding (QARV),
    per block of the decoder up to the stop marker its stencil and MLP,
    prior, fuse and upsample convs, and on decode the synthesis tail."""
    s = net['max_stride']
    h, w = H // s, W // s
    qarv = net['family'] == 'qarv'
    E = net.get('embed_dim', 0)
    calls = []

    def adaln(C, k, mr):
        hid = int(mr * C)
        calls.append(('dw_ln_mod', (_m(B, h, w, C), _m(k, k, C), _m(C),
                                    _m(E, 2 * C), _m(2 * C), _m(B, E), k)))
        calls.append(('mlp_res', (_m(B, h * w, C), _m(C, hid), _m(hid),
                                  _m(hid, C), _m(C), _m(C), _m(B, h * w, C))))

    def plain(C, k):
        calls.append(('dw_ln_affine', (_m(B, h, w, C), _m(k, k, C), _m(C),
                                       _m(C), _m(C), k)))
        calls.append(('mlp_res', (_m(B, h * w, C), _m(C, 2 * C), _m(2 * C),
                                  _m(2 * C, C), _m(C), _m(C),
                                  _m(B, h * w, C))))

    if qarv:
        calls.append(('emb_mlp', (_m(B), _m(E // 2), _m(E, E), _m(E),
                                  _m(E, E), _m(E), net['sin_period'])))
    from reference.nets import stop_index
    kinds = [b[0] for b in net['dec']]
    stop = stop_index(net['dec'])
    last_up = max(i for i, k in enumerate(kinds) if k == 'up')
    blocks = net['dec'] if direction == 'dec' else net['dec'][:stop]
    for i, blk in enumerate(blocks):
        kind, *a = blk
        if kind == 'rb':
            adaln(a[0], a[1], a[2])
        elif kind == 'cnx':
            plain(a[0], a[1])
        elif kind == 'latent':
            C, Z, _, _, k, mr, _ = a
            adaln(C, k, mr)
            calls.append(('prior_head', (_m(B, h * w, C), _m(C, 2 * Z),
                                         _m(2 * Z), _m(64))))
            calls.append(('fuse_zproj', (_m(B, h * w, C), _m(B, h * w, Z),
                                         _m(B, h * w, Z), _m(Z, C), _m(C))))
            adaln(C, k, mr)
        elif kind == 'qlatent':
            C, Z, k, _ = a
            hid = C // 4
            plain(C, k)
            calls.append(('dense_act', (_m(B, h * w, C), _m(C, hid),
                                        _m(hid))))
            for _ in range(2):
                if k >= 3:
                    calls.append(('conv_kxk_act', (_m(B, h, w, hid),
                                                   _m(9 * hid, hid),
                                                   _m(hid))))
                else:
                    calls.append(('dense_act', (_m(B, h * w, hid),
                                                _m(hid, hid), _m(hid))))
            calls.append(('prior_head', (_m(B, h * w, hid), _m(hid, 2 * Z),
                                         _m(2 * Z), _m(64))))
            h2 = hid // 2
            if k >= 3:
                calls.append(('zadd_conv_kxk', (_m(B, h, w, Z),
                                                _m(B, h, w, Z),
                                                _m(9 * Z, h2), _m(h2))))
            else:
                calls.append(('zadd_dense', (_m(B, h * w, Z), _m(B, h * w, Z),
                                             _m(Z, h2), _m(h2))))
            calls.append(('res_dense_act', (_m(B, h * w, C), _m(B, h * w, h2),
                                            _m(h2, C), _m(C))))
            plain(C, k)
        elif kind == 'up':
            cin, cout, r = a
            if i == last_up:
                calls.append(('upsample_finish', (_m(B, h, w, cin),
                                                  _m(cin, cout * r * r),
                                                  _m(cout * r * r), r)))
            else:
                calls.append(('dense', (_m(B, h * w, cin),
                                        _m(cin, cout * r * r),
                                        _m(cout * r * r))))
            h, w = h * r, w * r
        elif kind != 'stop':
            raise ValueError(f'no trunk computation for block {kind!r}')
    return calls


def least_seconds(calls):
    """The trunk's least time on the card: per computation the larger of
    its bytes over the HBM rate and its operations over the float32 rate,
    summed."""
    total = 0.0
    for name, args in calls:
        nbytes, ops = work(name, args)
        total += max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S)
    return total


def reference_flops(net_cfg, direction, B, H, W, passes=3):
    """Operations (2 a multiply-add) of the plain reference's convolutions
    and products, counted by torch.utils.flop_counter on the meta device:
    the encode to symbols ('enc'), the decode from them ('dec'), or the
    training loss's forward times `passes` ('train': the backward of each
    product costs two forwards, the input's and the weight's gradients)."""
    from torch.utils.flop_counter import FlopCounterMode
    from reference.nets import CodecNet
    with torch.device('meta'):
        net = CodecNet(net_cfg).requires_grad_(False)
        im = torch.empty(B, 3, H, W)
        lmb = torch.full((B,), 128.0) if net.qarv else None
        with FlopCounterMode(display=False) as counter:
            with torch.no_grad():
                if direction == 'enc':
                    net.encode(im, lmb)
                elif direction == 'dec':
                    syms, _ = net.encode(im, lmb)
                    counter.flop_counts.clear()
                    net.decode(syms, lmb, (H // net.max_stride,
                                           W // net.max_stride))
                else:
                    net.train_loss(im, None, mse_lmb=1.0)
    total = float(counter.get_total_flops())
    return total * (passes if direction == 'train' else 1)
