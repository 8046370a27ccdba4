"""Evaluation harness, counterpart of ``lvae_tpu/evaluation.py``: the true
file round trip (imcoding_evaluate) and the forward-only estimates
(image_self_evaluate, video_fast_evaluate) over a dataset directory.

Metrics as the JAX package computes them: bpp is the file's bits over the
ORIGINAL pixel count, PSNR is on RGB in [0, 1], and each metric is averaged
over the images. Images are PNGs read by ``utils.coding.read_png`` (the
card's machine has no image library): a dataset file with another image
suffix raises, naming the file.
"""
import math
import tempfile
from collections import defaultdict
from pathlib import Path

import numpy as np

from lvae_tpu_torch.paths import known_datasets
from lvae_tpu_torch.utils import coding

__all__ = ['imcoding_evaluate', 'image_self_evaluate', 'video_fast_evaluate']


def _find_images(dataset):
    root = known_datasets.get(dataset, Path(dataset))
    img_paths = coding.image_paths(root)
    if not img_paths:
        raise FileNotFoundError(f'no images found under {root}')
    return img_paths


def _progress(paths, progress):
    if progress:
        try:
            from tqdm import tqdm
        except ImportError:
            return paths
        return tqdm(paths, ascii=True)
    return paths


def _averages(per_image):
    """Mean of each numeric stat over the images' stats dicts."""
    sums, counts = defaultdict(float), defaultdict(int)
    for stats in per_image:
        for k, v in stats.items():
            if isinstance(v, (int, float)):
                sums[k] += v
                counts[k] += 1
    return {k: sums[k] / counts[k] for k in sums}


def imcoding_evaluate(model, dataset: str, progress=True, shape_buckets=None):
    """True file round trip of every image of `dataset` (a known dataset's
    name or a directory): compress_file -> the file's bits ->
    decompress_file -> {'bpp', 'mse', 'psnr'} averaged over the images.

    shape_buckets: None pads each image to the model's stride; an int N
    pads every image to one of <= N (H, W) buckets (compress_file's
    pad_hw), so a mixed-shape dataset runs O(N) image shapes; bpp still
    counts the file's bits over the original pixels."""
    img_paths = _find_images(dataset)
    buckets = None
    if shape_buckets is not None:
        sizes = [coding.png_size(p) for p in img_paths]
        buckets = coding.choose_shape_buckets(
            sizes, div=getattr(model, 'max_stride', 64),
            max_buckets=int(shape_buckets))
    per_image = []
    iterator = _progress(img_paths, progress)
    with tempfile.TemporaryDirectory() as tmp:
        for impath in iterator:
            bits_path = Path(tmp) / f'{impath.stem}.bits'
            if buckets is not None:
                h, w = coding.png_size(impath)
                model.compress_file(impath, bits_path,
                                    pad_hw=coding.bucket_for(h, w, buckets))
            else:
                model.compress_file(impath, bits_path)
            num_bits = bits_path.stat().st_size * 8
            fake = np.asarray(model.decompress_file(bits_path))[0]
            bits_path.unlink()
            real = coding.read_png(impath).astype(np.float32) / 255.0
            mse = float(np.mean(np.square(real - fake)))
            stats = {'bpp': float(num_bits / float(real.shape[0]
                                                   * real.shape[1])),
                     'mse': mse,
                     'psnr': float(-10 * math.log10(max(mse, 1e-12)))}
            per_image.append(stats)
            if hasattr(iterator, 'set_description'):
                msg = ', '.join(f'{k}={v:.3f}' for k, v in stats.items())
                iterator.set_description(f'image {impath.stem}: {msg}')
    return _averages(per_image)


def image_self_evaluate(model, dataset: str, progress=True):
    """model.forward on every image of `dataset`, center-cropped to the
    model's stride where it has one -> each numeric stat averaged over the
    images."""
    per_image = []
    for impath in _progress(_find_images(dataset), progress):
        img = coding.read_png(impath)
        if hasattr(model, 'max_stride'):
            img = coding.crop_divisible_by(img, div=model.max_stride)
        stats = model.forward(img.astype(np.float32)[None] / 255.0)
        if not isinstance(stats, dict):
            raise TypeError(f'model.forward returned {type(stats).__name__}, '
                            f'not a dict of stats')
        per_image.append(stats)
    return _averages(per_image)


def video_fast_evaluate(model, dataset='uvg-1080p', max_frames=None):
    """Estimated (no entropy coding) video evaluation: each sequence
    directory's frames (cropped to a multiple of 64) through
    model.forward_eval -> each numeric stat averaged over the sequences.
    No model of the port (or of the JAX package) defines forward_eval."""
    root = Path(known_datasets.get(dataset, Path(dataset)))
    if not root.is_dir():
        raise FileNotFoundError(f'cannot find {root} as a directory')
    accumulated = defaultdict(float)
    count = 0
    for seq_path in sorted(p for p in root.iterdir() if p.is_dir()):
        frame_paths = coding.image_paths(seq_path)
        if max_frames is not None:
            frame_paths = frame_paths[:max_frames]
        frames = [coding.crop_divisible_by(coding.read_png(fp), div=64)
                  .astype(np.float32)[None] / 255.0 for fp in frame_paths]
        stats = model.forward_eval(frames)
        count += 1
        for k, v in stats.items():
            if isinstance(v, (int, float)):
                accumulated[k] += v
    return {k: v / count for k, v in accumulated.items()}
