"""The one generator of the benchmark's inputs, read from a traffic file:
the photographs and their seeded variants, the pool of distinct requests,
the seeded order the window cycles it in, and the training crops.

Every seed gets the same work: the pool holds `per_lambda` requests at each
of the mix's lambdas (or `pool` requests of a fixed-rate model), so a seed
changes which image variants a request holds and the order, not the sizes
or the lambdas."""
import numpy as np
import torch

from harness.png import read_png
from harness.spec import ROOT

TRANSFORMS = ('none', 'hflip', 'rot180', 'vflip')


def photos(traffic, root=ROOT):
    """The traffic's photographs, (n, H, W, 3) uint8."""
    ims = [read_png(root / p) for p in traffic['images']]
    H, W = traffic['height'], traffic['width']
    for p, im in zip(traffic['images'], ims):
        if im.shape[:2] != (H, W):
            raise ValueError(f'{p}: {im.shape[:2]}, the mix says {(H, W)}')
    return np.stack(ims)


def _variant(im, t):
    if t == 'hflip':
        return im[:, ::-1]
    if t == 'vflip':
        return im[::-1]
    if t == 'rot180':
        return im[::-1, ::-1]
    return im


def variants(ims):
    """Every photograph under every transform: (n * 4, H, W, 3) uint8; each
    keeps its landscape shape."""
    return np.stack([_variant(im, t) for im in ims for t in TRANSFORMS])


def rng(seed, stream):
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


class Request:
    __slots__ = ('index', 'variants', 'lmb')

    def __init__(self, index, variant_ids, lmb):
        self.index, self.variants, self.lmb = index, variant_ids, lmb


def request_pool(traffic, seed, n_variants):
    """The pool of distinct requests: each `batch` variant ids drawn from the
    seed, at one lambda (None for a fixed-rate model)."""
    r = rng(seed, 1)
    lambdas = traffic.get('lambdas') or [None]
    per = traffic['per_lambda']
    pool = []
    for lmb in lambdas:
        for _ in range(per):
            ids = r.choice(n_variants, traffic['batch'], replace=False)
            pool.append(Request(len(pool), ids.tolist(), lmb))
    return pool


def order(pool, seed):
    """The window's requests: the pool in a fresh seeded permutation each
    cycle, without end."""
    r = rng(seed, 2)
    while True:
        for i in r.permutation(len(pool)):
            yield pool[int(i)]


def device_batches(pool, var_u8, device):
    """{pool index: (B, H, W, 3) float32 in [0, 1] on the device}: the
    requests' images, device-resident before the window."""
    dev = torch.as_tensor(var_u8).to(device)
    return {q.index: dev[q.variants].float().div_(255.0) for q in pool}


def training_crops(traffic, seed, ims, n_steps, device):
    """`n_steps` batches of `batch` random crops (crop x crop, each with a
    seeded horizontal flip), uint8 NHWC on the device, every row different:
    the crops are drawn without repeating a (photo, corner, flip)."""
    r = rng(seed, 3)
    B, c = traffic['batch'], traffic['crop']
    n, H, W, _ = ims.shape
    seen, rows = set(), []
    while len(rows) < n_steps * B:
        key = (int(r.integers(n)), int(r.integers(H - c + 1)),
               int(r.integers(W - c + 1)), bool(r.integers(2)))
        if key in seen:
            continue
        seen.add(key)
        i, y, x, flip = key
        crop = ims[i, y:y + c, x:x + c]
        rows.append(crop[:, ::-1] if flip else crop)
    arr = np.ascontiguousarray(np.stack(rows))
    t = torch.as_tensor(arr).to(device)
    return [t[k * B:(k + 1) * B] for k in range(n_steps)]
