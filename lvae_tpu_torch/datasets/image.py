"""Image dataset and transforms, counterpart of
``lvae_tpu/datasets/image.py``: NHWC uint8 or float32 crops from a folder
of images, the transform configured by a string ('crop=256,hflip=True')
read by a small parser (no eval). PNGs are read with utils/coding.read_png;
other suffixes through Pillow, imported only when such a file is read."""
import hashlib
from pathlib import Path

import numpy as np

from lvae_tpu_torch.paths import known_datasets
from lvae_tpu_torch.utils import coding

__all__ = ['ImageDataset', 'RandomCropFlip', 'get_image_dateset',
           'get_image_dataset', 'parse_transform_cfg', 'read_rgb',
           'reflect_pad_to']


def parse_transform_cfg(cfg_str):
    """Parse 'crop=256,hflip=True' into a dict: booleans, then ints, then
    floats (safe, no eval). The CLIs read their model arguments with it."""
    out = {}
    if not cfg_str:
        return out
    for item in cfg_str.split(','):
        item = item.strip()
        if not item:
            continue
        k, _, v = item.partition('=')
        v = v.strip()
        if v.lower() in ('true', 'false'):
            out[k.strip()] = v.lower() == 'true'
        else:
            try:
                out[k.strip()] = int(v)
            except ValueError:
                out[k.strip()] = float(v)
    return out


def read_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 of an image file: a PNG by read_png, anything else by
    Pillow's convert('RGB') (which read_png matches on PNGs)."""
    path = Path(path)
    if path.suffix.lower() == '.png':
        return coding.read_png(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f'{path}: reading {path.suffix} files needs '
                           f'Pillow, which is not installed; convert the '
                           f'set to PNG') from e
    with Image.open(path) as img:
        return np.asarray(img.convert('RGB'))


def reflect_pad_to(arr: np.ndarray, c: int) -> np.ndarray:
    """Reflect-pad an HWC image up to at least c x c (no-op when large
    enough). Shared by RandomCropFlip and the device-resident cache so that
    the crop-coordinate draws see identical (h, w) ranges on both paths."""
    h, w = arr.shape[:2]
    if h >= c and w >= c:
        return arr
    pad_h, pad_w = max(0, c - h), max(0, c - w)
    return np.pad(arr, ((pad_h // 2, pad_h - pad_h // 2),
                        (pad_w // 2, pad_w - pad_w // 2), (0, 0)),
                  mode='reflect')


class RandomCropFlip:
    """Random crop (reflect-padded where the image is smaller) and an
    optional horizontal flip, drawn from the batch's rng in this order:
    top, left, flip."""

    def __init__(self, crop=None, hflip=False):
        self.crop = crop
        self.hflip = hflip

    def __call__(self, arr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if self.crop is not None:
            c = self.crop
            arr = reflect_pad_to(arr, c)
            h, w = arr.shape[:2]
            top = int(rng.integers(0, h - c + 1))
            left = int(rng.integers(0, w - c + 1))
            arr = arr[top:top + c, left:left + c]
        if self.hflip and rng.random() < 0.5:
            arr = arr[:, ::-1]
        return np.ascontiguousarray(arr)

    def __repr__(self):
        return f'RandomCropFlip(crop={self.crop}, hflip={self.hflip})'


class ImageDataset:
    """Images under `root` (recursively, sorted), each transformed from the
    batch's rng. out_dtype=np.uint8 gives raw 0-255 crops (the trainer
    normalises on the device); float32 gives u8 / 255.

    decode_cache=True decodes every image once into a raw uint8 blob under
    <root>/.lvae_u8cache/ (keyed by the files' names, sizes and mtimes),
    read back through np.memmap: the JAX package's cache, in its format."""

    def __init__(self, root, transform: RandomCropFlip = None,
                 out_dtype=np.float32, decode_cache=False):
        self.root = root
        self.transform = transform or RandomCropFlip()
        self.out_dtype = np.dtype(out_dtype)
        self.image_paths = sorted(
            p for p in Path(root).rglob('*.*')
            if p.suffix.lower() in coding.IMAGE_SUFFIXES
            and '.lvae_u8cache' not in p.parts)
        if not self.image_paths:
            raise FileNotFoundError(f'Found 0 images in {root}.')
        self._blob = None
        if decode_cache:
            self._build_decode_cache()

    def _build_decode_cache(self):
        cache_dir = Path(self.root) / '.lvae_u8cache'
        cache_dir.mkdir(exist_ok=True)
        sig = hashlib.sha256()
        for p in self.image_paths:
            st = p.stat()
            sig.update(f'{p.name}:{st.st_size}:{int(st.st_mtime)}'.encode())
        sig = sig.hexdigest()[:16]
        blob_path = cache_dir / 'blob.bin'
        idx_path = cache_dir / 'index.npz'
        if idx_path.is_file():
            idx = np.load(idx_path, allow_pickle=False)
            if str(idx['sig']) == sig and blob_path.is_file():
                self._offsets = idx['offsets']
                self._shapes = idx['shapes']
                self._blob = np.memmap(blob_path, np.uint8, mode='r')
                return
        offsets, shapes = [], []
        off = 0
        with open(blob_path, 'wb') as f:
            for p in self.image_paths:
                arr = read_rgb(p)
                f.write(arr.tobytes())
                offsets.append(off)
                shapes.append(arr.shape[:2])
                off += arr.nbytes
        self._offsets = np.asarray(offsets, np.int64)
        self._shapes = np.asarray(shapes, np.int32)
        np.savez(idx_path, sig=sig, offsets=self._offsets,
                 shapes=self._shapes)
        self._blob = np.memmap(blob_path, np.uint8, mode='r')

    def __len__(self):
        return len(self.image_paths)

    def _load_u8(self, index) -> np.ndarray:
        if self._blob is not None:
            off = int(self._offsets[index])
            h, w = (int(v) for v in self._shapes[index])
            return np.asarray(self._blob[off:off + h * w * 3]
                              ).reshape(h, w, 3)
        return read_rgb(self.image_paths[index])

    def get(self, index, rng: np.random.Generator) -> np.ndarray:
        arr = self.transform(self._load_u8(index), rng)
        if self.out_dtype == np.uint8:
            return arr
        return arr.astype(np.float32) / 255.0

    def __getitem__(self, index):
        return self.get(index, np.random.default_rng())


def get_image_dateset(name: str, transform_cfg: str = None,
                      decode_cache=False) -> ImageDataset:
    """A dataset from a known name (paths.known_datasets) or a path, with
    the transform of `transform_cfg`. The misspelled name is the JAX
    package's; get_image_dataset is the same function."""
    cfg = parse_transform_cfg(transform_cfg)
    transform = RandomCropFlip(crop=cfg.get('crop'),
                               hflip=cfg.get('hflip', False))
    return ImageDataset(root=known_datasets.get(name, name),
                        transform=transform, decode_cache=decode_cache)


get_image_dataset = get_image_dateset
