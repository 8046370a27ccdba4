"""The port's data side against the JAX package's on the CPU: for the same
seed, shard and batch number the port's threaded loader and its device
cache (on CPU tensors) give batches byte-identical to the JAX
make_trainloader's and DeviceDataLoader's, over seeded PNGs of mixed sizes
(one smaller than the crop: the reflect pad), with flips, at two worker
counts and from a resumed batch number; the decode cache reads back the
same pixels and reuses itself; Vimeo90k on a synthetic folder of
septuplets draws the JAX package's windows; the general utilities."""
import numpy as np
import pytest
import torch
from PIL import Image

from lvae_tpu import parallel
from lvae_tpu.datasets import get_image_dateset as jax_dataset
from lvae_tpu.datasets import make_trainloader as jax_loader
from lvae_tpu.datasets.device_cache import DeviceDataLoader as JaxDevice
from lvae_tpu.datasets.video import Vimeo90k as JaxVimeo
from lvae_tpu.utils import general as jgeneral

from lvae_tpu_torch.datasets import get_image_dataset, make_trainloader
from lvae_tpu_torch.datasets import Vimeo90k
from lvae_tpu_torch.datasets.device_cache import DeviceDataLoader
from lvae_tpu_torch.datasets.image import read_rgb
from lvae_tpu_torch.utils import general

SIZES = [(80, 96), (70, 90), (64, 64), (50, 72), (100, 100)]
CROP = 64
B = 8
N_BATCHES = 6


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch calls: under the suite's
    parallel workers torch's default of one thread a core oversubscribes
    the machine, and these small calls then spend their time waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('imgs')
    rng = np.random.default_rng(5)
    for i, (h, w) in enumerate(SIZES):
        arr = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(d / f'im{i}.png')
    return d


def _u8(ds):
    ds.out_dtype = np.dtype(np.uint8)
    return ds


@pytest.fixture(scope='module')
def jax_batches(image_dir):
    ds = _u8(jax_dataset(str(image_dir), f'crop={CROP},hflip=True'))
    loader, _ = jax_loader(ds, batch_size=B, workers=1, seed=7)
    out = [next(loader).copy() for _ in range(N_BATCHES)]
    loader.stop()
    return out


def _port_set(image_dir, **kw):
    return _u8(get_image_dataset(str(image_dir), f'crop={CROP},hflip=True',
                                 **kw))


@pytest.mark.parametrize('workers', [1, 3])
def test_loader_batches_are_the_jax_loaders(image_dir, jax_batches, workers):
    loader, sampler = make_trainloader(_port_set(image_dir), batch_size=B,
                                       workers=workers, seed=7)
    try:
        for i, want in enumerate(jax_batches):
            got = next(loader)
            assert got.dtype == np.uint8 and got.shape == (B, CROP, CROP, 3)
            assert np.array_equal(got, want), f'batch {i}'
    finally:
        loader.stop()
    assert sampler.epoch == N_BATCHES * B // len(SIZES)


def test_loader_resumes_at_a_batch_number(image_dir, jax_batches):
    loader, _ = make_trainloader(_port_set(image_dir), batch_size=B,
                                 workers=2, seed=7, start_batch=4)
    try:
        assert np.array_equal(next(loader), jax_batches[4])
        assert np.array_equal(next(loader), jax_batches[5])
    finally:
        loader.stop()


def test_device_cache_batches_are_the_jax_caches(image_dir, jax_batches):
    ds = _u8(jax_dataset(str(image_dir), f'crop={CROP},hflip=True'))
    jdev = JaxDevice(ds, batch_size=B, mesh=parallel.get_data_mesh(), seed=7)
    port = DeviceDataLoader(_port_set(image_dir), batch_size=B,
                            device='cpu', seed=7)
    assert any(port.params_for(i)[:, 3].any() for i in range(N_BATCHES))
    for i, want in enumerate(jax_batches):
        got = next(port)
        assert torch.is_tensor(got) and got.dtype == torch.uint8
        assert np.array_equal(port.params_for(i), jdev._params_for(i))
        assert np.array_equal(got.numpy(), np.asarray(next(jdev)))
        assert np.array_equal(got.numpy(), want), f'batch {i}'
    resumed = DeviceDataLoader(_port_set(image_dir), batch_size=B,
                               device='cpu', seed=7, start_batch=5)
    assert np.array_equal(next(resumed).numpy(), jax_batches[5])


def test_sharded_streams_match_jax(image_dir):
    for shard in (0, 1):
        jl, _ = jax_loader(_u8(jax_dataset(str(image_dir), 'crop=32')),
                           batch_size=2, workers=1, num_shards=2,
                           shard_id=shard, seed=3)
        pl, _ = make_trainloader(
            _u8(get_image_dataset(str(image_dir), 'crop=32')), batch_size=2,
            workers=1, num_shards=2, shard_id=shard, seed=3)
        try:
            for _ in range(4):
                assert np.array_equal(next(pl), next(jl))
        finally:
            jl.stop()
            pl.stop()


def test_float32_items_and_decode_cache(image_dir, tmp_path):
    ds = get_image_dataset(str(image_dir), 'crop=48')
    jds = jax_dataset(str(image_dir), 'crop=48')
    for i in range(len(SIZES)):
        a = ds.get(i, np.random.default_rng(i))
        b = jds.get(i, np.random.default_rng(i))
        assert a.dtype == np.float32 and np.array_equal(a, b)
    cached = tmp_path / 'cached'
    cached.mkdir()
    for p in sorted(image_dir.glob('*.png')):
        (cached / p.name).write_bytes(p.read_bytes())
    first = get_image_dataset(str(cached), 'crop=48', decode_cache=True)
    blob = cached / '.lvae_u8cache' / 'blob.bin'
    mtime = blob.stat().st_mtime_ns
    again = get_image_dataset(str(cached), 'crop=48', decode_cache=True)
    assert blob.stat().st_mtime_ns == mtime          # reused, not rebuilt
    assert len(again) == len(SIZES)                  # the cache is no image
    for i, p in enumerate(sorted(cached.glob('*.png'))):
        want = np.asarray(Image.open(p).convert('RGB'))
        assert np.array_equal(first._load_u8(i), want)
        assert np.array_equal(again._load_u8(i), want)


def test_non_png_reader(tmp_path):
    arr = np.random.default_rng(0).integers(0, 255, (9, 7, 3), np.uint8)
    Image.fromarray(arr).save(tmp_path / 'a.bmp')
    assert np.array_equal(read_rgb(tmp_path / 'a.bmp'), arr)


def test_vimeo90k_windows_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    for s in range(3):
        seq = tmp_path / f'{s:05d}' / '0001'
        seq.mkdir(parents=True)
        for f in range(7):
            Image.fromarray(rng.integers(0, 255, (40, 48, 3), np.uint8)).save(
                seq / f'im{f + 1}.png')
    from lvae_tpu.datasets.image import RandomCropFlip as JCrop
    from lvae_tpu_torch.datasets.image import RandomCropFlip
    port = Vimeo90k(tmp_path, frames=3, transform=RandomCropFlip(32, True))
    ref = JaxVimeo(tmp_path, frames=3, transform=JCrop(32, True))
    assert len(port) == len(ref) == 3
    for i in range(3):
        for seed in range(4):
            a = port.get(i, np.random.default_rng(seed))
            b = ref.get(i, np.random.default_rng(seed))
            assert len(a) == 3
            assert all(x.shape == (32, 32, 3) and np.array_equal(x, y)
                       for x, y in zip(a, b))


def test_general_utilities(tmp_path):
    buf, jbuf = general.MaxLengthList(3), jgeneral.MaxLengthList(3)
    for v in (5.0, 1.0, 4.0, 2.0):
        buf.add(v)
        jbuf.add(v)
    assert (buf.median(), buf.current(), buf.max(), len(buf)) == \
        (jbuf.median(), jbuf.current(), jbuf.max(), len(jbuf))
    t = general.SimpleTable(['a', 'bb'])
    t['a'], t['bb'], t['c'] = 1.5, 'x', 2
    jt = jgeneral.SimpleTable(['a', 'bb'])
    jt['a'], jt['bb'], jt['c'] = 1.5, 'x', 2
    assert t.update(border=True) == jt.update(border=True)
    (tmp_path / 'run_0').mkdir()
    (tmp_path / 'run_3').mkdir()
    assert general.increment_dir(tmp_path, 'run') == \
        jgeneral.increment_dir(tmp_path, 'run') == 'run_4'
    general.json_dump({'x': [1, 2]}, tmp_path / 'a.json')
    assert general.json_load(tmp_path / 'a.json') == {'x': [1, 2]}
    general.print_to_file('hi', tmp_path / 'a.txt')
    assert general.read_file(tmp_path / 'a.txt') == 'hi\n'
    assert general.ANSI.colorstr('x') == jgeneral.ANSI.colorstr('x')
