"""The whole training set on the card, counterpart of
``lvae_tpu/datasets/device_cache.py``: the uint8 images are stacked once
into one (N, maxH, maxW, 3) tensor on the device, and each batch is
gathered, cropped and flipped there by one indexing call from a (B, 4)
parameter array [image index, crop top, crop left, hflip] drawn on the
host. The per-step host-to-device traffic is those parameters instead of
the pixels.

The parameters come from the sampler and the per-batch rng of
datasets/loader.py in the same order as RandomCropFlip draws them, so the
batches are byte-identical to the threaded loader's uint8 batches. Single
process.
"""
import numpy as np
import torch

from lvae_tpu_torch.datasets.image import reflect_pad_to
from lvae_tpu_torch.datasets.loader import ShardedSampler, batch_rng

__all__ = ['DeviceDataLoader']


class DeviceDataLoader:
    """Infinite iterator of (B, crop, crop, 3) uint8 batches on `device`,
    from batch number `start_batch` on."""

    def __init__(self, dataset, batch_size, device, num_shards=1, shard_id=0,
                 seed=0, max_bytes=8 << 30, start_batch=0):
        tr = dataset.transform
        if not tr.crop:
            raise ValueError('the device data cache needs a crop size')
        self.crop = int(tr.crop)
        self.hflip = bool(tr.hflip)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.shard_id = int(shard_id)
        self.sampler = ShardedSampler(len(dataset), num_shards, shard_id,
                                      seed)
        c = self.crop
        # images smaller than the crop are reflect-padded exactly as
        # RandomCropFlip pads them, so that the crop draws see the same
        # (h, w) ranges as the threaded loader's
        arrs = [reflect_pad_to(dataset._load_u8(i), c)
                for i in range(len(dataset))]
        dims = [a.shape[:2] for a in arrs]
        maxH = max(d[0] for d in dims)
        maxW = max(d[1] for d in dims)
        nbytes = len(arrs) * maxH * maxW * 3
        if nbytes > max_bytes:
            raise ValueError(
                f'the device data cache would need {nbytes / 1e9:.1f} GB '
                f'({len(arrs)} images padded to {maxH}x{maxW}); use the '
                'threaded loader (--no-device_data) for a set this large')
        stack = np.zeros((len(arrs), maxH, maxW, 3), np.uint8)
        for i, a in enumerate(arrs):
            stack[i, :a.shape[0], :a.shape[1]] = a
        self.dims = np.asarray(dims, np.int64)
        self.device = torch.device(device)
        self.images = torch.from_numpy(stack).to(self.device)
        self._offs = torch.arange(c, device=self.device)
        self._bn = int(start_batch)

    def params_for(self, bn):
        """(B, 4) int32 [image index, crop top, crop left, hflip] of batch
        `bn`: the threaded loader's sampler positions and rng draws, in
        RandomCropFlip's order."""
        B, c = self.batch_size, self.crop
        rng = batch_rng(self.seed, self.shard_id, bn)
        out = np.zeros((B, 4), np.int32)
        for j in range(B):
            i = self.sampler.index_at(bn * B + j)
            h, w = (int(v) for v in self.dims[i])
            top = int(rng.integers(0, h - c + 1))
            left = int(rng.integers(0, w - c + 1))
            flip = 1 if (self.hflip and rng.random() < 0.5) else 0
            out[j] = (i, top, left, flip)
        return out

    def build(self, prm):
        """The batch of a (B, 4) int64 parameter tensor on the device: one
        gather of each image's crop, its columns reversed where flipped."""
        offs, c = self._offs, self.crop
        rows = prm[:, 1:2] + offs                                 # (B, c)
        cols = torch.where(prm[:, 3:4] > 0, c - 1 - offs, offs) + prm[:, 2:3]
        return self.images[prm[:, 0, None, None], rows[:, :, None],
                           cols[:, None, :]]

    def __iter__(self):
        return self

    def __next__(self):
        prm = torch.from_numpy(self.params_for(self._bn).astype(np.int64))
        if self.device.type == 'cuda':
            prm = prm.pin_memory()
        self._bn += 1
        # epoch bookkeeping, as the threaded loader keeps it
        self.sampler.epoch = (self._bn * self.batch_size) \
            // self.sampler.shard_len
        return self.build(prm.to(self.device, non_blocking=True))

    def stop(self):
        pass
