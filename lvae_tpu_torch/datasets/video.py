"""Vimeo-90k septuplets, counterpart of ``lvae_tpu/datasets/video.py``: a
random window of `frames` consecutive frames of each sequence, with a
random time reversal and one crop and flip shared by the frames."""
from pathlib import Path

import numpy as np

from lvae_tpu_torch.datasets.image import RandomCropFlip, read_rgb
from lvae_tpu_torch.paths import known_datasets

__all__ = ['Vimeo90k']


class Vimeo90k:
    """Sequence folders of PNG frames under `root` (the vimeo-90k store when
    None). get() -> `frames` float32 (H, W, 3) frames in [0, 1]."""

    def __init__(self, root=None, frames=3, transform=None):
        root = Path(root) if root is not None else known_datasets['vimeo-90k']
        self.root = root
        self.frames = frames
        self.transform = transform or RandomCropFlip()
        self.sequence_dirs = sorted(d for d in Path(root).rglob('*')
                                    if d.is_dir() and any(d.glob('*.png')))
        if not self.sequence_dirs:
            raise FileNotFoundError(f'no sequences under {root}')

    def __len__(self):
        return len(self.sequence_dirs)

    def get(self, index, rng: np.random.Generator):
        frame_paths = sorted(self.sequence_dirs[index].glob('*.png'))
        n = len(frame_paths)
        if n < self.frames:
            raise ValueError(f'{self.sequence_dirs[index]} has {n} frames')
        start = int(rng.integers(0, n - self.frames + 1))
        window = frame_paths[start:start + self.frames]
        if rng.random() < 0.5:                      # random time reversal
            window = window[::-1]
        frames = [read_rgb(p).astype(np.float32) / 255.0 for p in window]
        # one crop and flip for all frames, so that they stay aligned
        stacked = self.transform(np.concatenate(frames, axis=-1), rng)
        return [stacked[..., 3 * i:3 * (i + 1)] for i in range(self.frames)]

    def __getitem__(self, index):
        return self.get(index, np.random.default_rng())
