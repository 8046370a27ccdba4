"""Training and validation data, counterpart of ``lvae_tpu/datasets/``:
image folders with a random crop and flip (image.py), the threaded
infinite loader (loader.py), the whole training set on the card
(device_cache.py) and Vimeo-90k triplets (video.py). Images are read with
utils/coding.read_png: the card's machine has no Pillow."""
from lvae_tpu_torch.datasets.image import (
    ImageDataset, get_image_dateset, get_image_dataset, parse_transform_cfg,
)
from lvae_tpu_torch.datasets.loader import make_trainloader, ShardedSampler
from lvae_tpu_torch.datasets.video import Vimeo90k

__all__ = ['ImageDataset', 'get_image_dateset', 'get_image_dataset',
           'parse_transform_cfg', 'make_trainloader', 'ShardedSampler',
           'Vimeo90k']
