"""The port's eval harness (lvae_tpu_torch/evaluation.py, the coding
helpers it uses, compress_file(pad_hw=) and the eval CLIs) against the JAX
package's on the CPU: the helpers on arrays and size lists, BD-rates on the
committed Kodak curves, and the file sweep on qarv_tiny (the portable
stream is byte-identical there, so bpp is equal) and qres_tiny (symbols may
differ at rounding boundaries: bpp within 1 %), on the same random weights.
"""
import importlib.util
import json
import pickle
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from PIL import Image
from scipy.ndimage import gaussian_filter

import lvae_tpu
from lvae_tpu import evaluation as jeval
from lvae_tpu.utils import coding as jcoding

import lvae_tpu_torch
from lvae_tpu_torch import eval_fix_rate, eval_var_rate, evaluation as teval
from lvae_tpu_torch.datasets import parse_transform_cfg
from lvae_tpu_torch.models.weights import params_from_flax
from lvae_tpu_torch.utils import coding as tcoding

ROOT = Path(__file__).resolve().parent.parent
SIZES = [(100, 90), (128, 128)]
PSNR_TOL_DB = 1e-4


def _redraw_prior(params, rng):
    """Each QRes prior's last conv at lecun-normal scale: flax
    zero-initialises it, which would leave pm = 0 and one scale index."""
    for name, blk in params.items():
        if name.startswith('dec_blocks_') and 'prior' in blk:
            c4 = blk['prior']['c4']
            fan_in = c4['kernel'].shape[2]
            c4['kernel'] = (rng.normal(size=c4['kernel'].shape)
                            / np.sqrt(fan_in)).astype(np.float32)
    return params


def _pair(name, rng=None):
    jm = lvae_tpu.get_model(name)
    params = jax.device_get(jm.params)
    if rng is not None:
        params = _redraw_prior(params, rng)
        jm.params = jax.tree.map(jnp.asarray, params)
    tm = lvae_tpu_torch.get_model(name, device='cpu')
    tm.net.load_state_dict(params_from_flax(params), strict=True)
    jm.compress_mode()
    tm.compress_mode()
    return jm, tm


@pytest.fixture(scope='module')
def qarv():
    return _pair('qarv_tiny')


@pytest.fixture(scope='module')
def qres():
    return _pair('qres_tiny', np.random.default_rng(0))


@pytest.fixture(scope='module')
def img_dir(tmp_path_factory):
    """Two smooth photos-like PNGs, 100x90 and 128x128."""
    d = tmp_path_factory.mktemp('harness')
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(SIZES):
        im = gaussian_filter(rng.uniform(0, 1, (h, w, 3)), sigma=(3, 3, 0))
        im = (im - im.min()) / (im.max() - im.min() + 1e-9)
        Image.fromarray((im * 255).astype(np.uint8)).save(
            d / f'harness{i}.png')
    return d


# ---- the coding helpers -------------------------------------------------

@pytest.mark.parametrize('shape,target', [
    ((100, 90, 3), (128, 128)), ((128, 128, 3), (128, 128)),
    ((1, 1, 3), (64, 128)), ((65, 130, 3), (192, 192)),
    ((37, 20), (64, 64))])
def test_pad_and_crop_equal_the_pil_versions(shape, target):
    arr = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(jcoding.pad_to_shape(Image.fromarray(arr), *target))
    got = tcoding.pad_to_shape(arr, *target)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    for div in (1, 16, 64):
        if shape[0] >= div and shape[1] >= div:
            want = np.asarray(jcoding.crop_divisible_by(
                Image.fromarray(arr), div=div))
            assert np.array_equal(tcoding.crop_divisible_by(arr, div=div),
                                  want)
    with pytest.raises(ValueError):
        tcoding.pad_to_shape(arr, shape[0] - 1, target[1])


@pytest.mark.parametrize('mode', ['RGB', 'RGBA', 'L', 'LA', 'P'])
def test_png_size_reads_the_header(mode, tmp_path):
    """png_size: Pillow's size of the file (and read_png's shape), from the
    header alone; a file that is not a PNG raises, naming it."""
    rng = np.random.default_rng(3)
    for h, w in ((1, 1), (37, 130), (300, 17)):
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        path = tmp_path / f'{mode}-{h}x{w}.png'
        Image.fromarray(arr).convert(mode).save(path)
        with Image.open(path) as saved:
            assert tcoding.png_size(path) == saved.size[::-1] == (h, w)
        assert tcoding.read_png(path).shape == (h, w, 3)
    Image.fromarray(arr).save(tmp_path / 'photo.jpg')
    with pytest.raises(ValueError, match='photo.jpg'):
        tcoding.png_size(tmp_path / 'photo.jpg')


def test_known_datasets_lie_in_the_checkout_or_the_variable(tmp_path,
                                                            monkeypatch):
    """The dataset store is datasets/ inside the checkout, or what
    LVAE_TPU_DATASETS names: no name resolves anywhere else."""
    import importlib
    from lvae_tpu_torch import paths
    try:
        monkeypatch.delenv('LVAE_TPU_DATASETS', raising=False)
        importlib.reload(paths)
        assert 'kodak' in paths.known_datasets
        assert all(p.is_relative_to(ROOT / 'datasets')
                   for p in paths.known_datasets.values())
        monkeypatch.setenv('LVAE_TPU_DATASETS', str(tmp_path))
        importlib.reload(paths)
        assert all(p.is_relative_to(tmp_path.resolve())
                   for p in paths.known_datasets.values())
    finally:
        monkeypatch.undo()
        importlib.reload(paths)


@pytest.mark.parametrize('seed', range(4))
def test_shape_buckets_equal_the_jax_ones(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 3, 7, 20):
        sizes = [tuple(int(v) for v in rng.integers(1, 700, 2))
                 for _ in range(n)]
        for div in (16, 64):
            for max_buckets in (1, 2, 3, 5):
                want = jcoding.choose_shape_buckets(sizes, div, max_buckets)
                got = tcoding.choose_shape_buckets(sizes, div, max_buckets)
                assert got == want
                for h, w in sizes:
                    assert (tcoding.bucket_for(h, w, got)
                            == jcoding.bucket_for(h, w, want))


class _Axis:
    """Records ax.plot calls."""

    def __init__(self):
        self.calls = []

    def plot(self, *args, **kwargs):
        self.calls.append((args, kwargs))


def test_bd_rate_and_rdlist_equal_the_jax_ones():
    curves = {'vtm': ROOT / 'results/kodak/kodak-vtm18.0.json',
              'qarv': ROOT / 'results/kodak/kodak-qarv_base.json',
              'qres': ROOT / 'results/kodak/kodak-qres34m.json'}
    res = {k: json.loads(p.read_text()) for k, p in curves.items()}
    res = {k: v.get('results', v) for k, v in res.items()}
    for k in ('qarv', 'qres'):
        want = jcoding.bd_rate(res['vtm']['bpp'], res['vtm']['psnr'],
                               res[k]['bpp'], res[k]['psnr'])
        got = tcoding.bd_rate(res['vtm']['bpp'], res['vtm']['psnr'],
                              res[k]['bpp'], res[k]['psnr'])
        assert abs(got - want) <= 1e-12 and got < 0
    out, axes = [], []
    for mod in (jcoding, tcoding):
        rd = mod.RDList()
        for k, p in curves.items():
            rd.add_json(p, label=k, color=k)
        rd.add_data(bpp=[0.4, 0.6, 1.0, 1.5], psnr=[29.0, 31.0, 33.0, 35.5],
                    label='pts')
        rd.set_bdrate_anchor('vtm')
        out.append(rd.compute_bdrate())
        axes.append(_Axis())
        rd.plot_all_stats(axes[-1])
    assert out[0].keys() == out[1].keys()
    assert all(abs(out[0][k] - out[1][k]) <= 1e-12 for k in out[0])
    assert axes[0].calls == axes[1].calls and len(axes[1].calls) == 4


def test_parse_transform_cfg_equals_the_jax_parser():
    from lvae_tpu.datasets.image import parse_transform_cfg as jparse
    for s in ('lmb=2048,flag=True,x=1.5', '', 'crop=256,hflip=True',
              ' lmb = 64 , , flag=FALSE,scale=1e-3'):
        assert parse_transform_cfg(s) == jparse(s)


# ---- the file sweep -----------------------------------------------------

@pytest.mark.parametrize('buckets', [None, 2])
def test_imcoding_evaluate_qarv_tiny_equals_jax(qarv, img_dir, buckets):
    jm, tm = qarv
    for m in (jm, tm):
        m.default_lmb = 300.0
    want = jeval.imcoding_evaluate(jm, str(img_dir), progress=False,
                                   shape_buckets=buckets)
    got = teval.imcoding_evaluate(tm, str(img_dir), progress=False,
                                  shape_buckets=buckets)
    assert got.keys() == want.keys() == {'bpp', 'mse', 'psnr'}
    assert got['bpp'] == want['bpp']
    assert abs(got['psnr'] - want['psnr']) <= PSNR_TOL_DB


def test_imcoding_evaluate_qres_tiny_within_one_percent(qres, img_dir):
    jm, tm = qres
    want = jeval.imcoding_evaluate(jm, str(img_dir), progress=False,
                                   shape_buckets=2)
    got = teval.imcoding_evaluate(tm, str(img_dir), progress=False,
                                  shape_buckets=2)
    assert got.keys() == want.keys()
    assert abs(got['bpp'] / want['bpp'] - 1) <= 0.01
    assert np.isfinite(got['psnr']) and got['bpp'] > 0


def test_compress_file_pad_hw(qarv, qres, img_dir, tmp_path):
    """Each image padded to its bucket of 2: the qarv_tiny file equals the
    JAX package's byte for byte; padded further (192 x 192), its body is
    compress() of the edge-padded image. Both families decode to the
    stored size."""
    jm, tm = qarv
    qm = qres[1]
    paths = sorted(img_dir.glob('*.png'))
    buckets = tcoding.choose_shape_buckets(SIZES, div=64, max_buckets=2)
    for path, (h, w) in zip(paths, SIZES):
        pad_hw = tcoding.bucket_for(h, w, buckets)
        jm.compress_file(path, tmp_path / 'j.bits', lmb=512.0, pad_hw=pad_hw)
        tm.compress_file(path, tmp_path / 't.bits', lmb=512.0, pad_hw=pad_hw)
        assert ((tmp_path / 't.bits').read_bytes()
                == (tmp_path / 'j.bits').read_bytes())
        tm.compress_file(path, tmp_path / 't.bits', lmb=512.0,
                         pad_hw=(192, 192))
        padded = tcoding.pad_to_shape(tcoding.read_png(path), 192, 192)
        assert (tmp_path / 't.bits').read_bytes() == struct.pack(
            '2H', h, w) + tm.compress(padded[None] / np.float32(255),
                                      lmb=512.0, portable=True)
        for m, suffix in ((tm, 't'), (qm, 'q')):
            if m is qm:
                m.compress_file(path, tmp_path / 'q.bits', pad_hw=(192, 192))
            assert m.decompress_file(tmp_path / f'{suffix}.bits').shape == (
                1, h, w, 3)
    with pytest.raises(ValueError):
        tm.compress_file(paths[1], tmp_path / 't.bits', pad_hw=(64, 128))


def test_compress_file_follows_supports_portable(qres, img_dir, tmp_path):
    _, tm = qres
    path = sorted(img_dir.glob('*.png'))[0]
    assert tm._fused.supports_portable
    fields = []
    for portable in (None, False):
        tm.compress_file(path, tmp_path / 'q.bits', portable=portable)
        body = pickle.loads((tmp_path / 'q.bits').read_bytes())[0]
        fields.append(struct.unpack('<H', body[8:10])[0])
    assert fields == [0x8000 | 128, 128]


def test_a_file_that_is_not_a_png_raises_naming_it(qarv, tmp_path):
    _, tm = qarv
    Image.fromarray(np.zeros((64, 64, 3), np.uint8)).save(
        tmp_path / 'photo.jpg')
    with pytest.raises(ValueError, match='photo.jpg'):
        teval.imcoding_evaluate(tm, str(tmp_path), progress=False)
    with pytest.raises(FileNotFoundError):
        teval.imcoding_evaluate(tm, str(tmp_path / 'none'), progress=False)


# ---- the CLI ------------------------------------------------------------

def _root_cli(path):
    spec = importlib.util.spec_from_file_location('root_cli', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_eval_var_rate_writes_what_the_root_cli_writes(qarv, img_dir,
                                                       tmp_path, monkeypatch):
    """The port's CLI (on the CPU through main's device argument) and
    eval-var-rate.py on the same arguments, each with the fixture's model
    of its package (the same weights; the JAX executables compiled once):
    the same file, keys and lambdas; the results within the sweep's
    tolerances."""
    jm, tm = qarv
    anchor = str(ROOT / 'results/kodak/kodak-vtm18.0.json')
    argv = ['-m', 'qarv_tiny', '-n', str(img_dir), '-s', '2',
            '--bd_anchor', anchor]
    out = {}
    for side in ('jax', 'port'):
        cwd = tmp_path / side
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        if side == 'jax':
            cli = _root_cli(ROOT / 'eval-var-rate.py')
            cli.get_model = lambda name, **kw: jm
            monkeypatch.setattr(sys, 'argv', ['eval-var-rate.py'] + argv)
            with pytest.warns(np.exceptions.RankWarning):
                cli.main()
        else:
            made = []
            monkeypatch.setattr(eval_var_rate, 'get_model', lambda name, **kw:
                                made.append((name, kw)) or tm)
            with pytest.warns(np.exceptions.RankWarning):
                ret = eval_var_rate.main(argv, device='cpu')
            assert made == [('qarv_tiny', {'device': 'cpu'})]
        path = cwd / 'runs' / 'results' / f'{img_dir.name}-qarv_tiny.json'
        out[side] = json.loads(path.read_text())
    want, got = out['jax'], out['port']
    assert list(got) == list(want) == ['name', 'test-set', 'platform',
                                       'device', 'lambdas', 'results',
                                       'bd-rate']
    assert got['lambdas'] == want['lambdas'] and len(got['lambdas']) == 2
    assert got['name'] == want['name'] and got['test-set'] == want['test-set']
    assert got['device'] == 'cpu' and ret['results'] == got['results']
    assert got['results']['bpp'] == want['results']['bpp']
    assert np.allclose(got['results']['psnr'], want['results']['psnr'],
                       rtol=0, atol=PSNR_TOL_DB)
    assert list(got['bd-rate']) == list(want['bd-rate'])


def test_eval_cli_needs_the_card_unless_told_otherwise(img_dir, tmp_path,
                                                      monkeypatch):
    import torch
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        eval_var_rate.main(['-m', 'qarv_tiny', '-n', str(img_dir)])
    assert not (tmp_path / 'runs').exists()


def test_eval_fix_rate_writes_what_the_root_cli_writes(qres, img_dir,
                                                       tmp_path, monkeypatch):
    """eval_fix_rate and eval-fix-rate.py on the same arguments, each given
    the fixture's qres_tiny of its package for every lambda: the models
    asked for (one a lambda, its weight file from the pattern), the file,
    the lambdas and the results (bpp within 1 %, as the file sweep); the
    port's file adds the platform and the device."""
    jm, tm = qres
    argv = ['-m', 'qres_tiny', '-n', str(img_dir), '-l', '16', '64',
            '-w', 'w-{lmb}.msgpack']
    out, made = {}, {}
    for side, mod, model in (
            ('jax', _root_cli(ROOT / 'eval-fix-rate.py'), jm),
            ('port', eval_fix_rate, tm)):
        cwd = tmp_path / side
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        made[side] = []
        monkeypatch.setattr(mod, 'get_model', lambda name, m=model, s=side,
                            **kw: made[s].append((name, kw)) or m)
        if side == 'jax':
            monkeypatch.setattr(sys, 'argv', ['eval-fix-rate.py'] + argv)
            mod.main()
        else:
            mod.main(argv, device='cpu')
        path = (cwd / 'runs' / 'results'
                / f'{str(img_dir).lstrip("/")}-qres_tiny.json')
        out[side] = json.loads(path.read_text())
    assert made['jax'] == [('qres_tiny', {'lmb': v, 'pretrained':
                                          f'w-{v}.msgpack'}) for v in (16, 64)]
    assert made['port'] == [(n, dict(kw, device='cpu'))
                            for n, kw in made['jax']]
    want, got = out['jax'], out['port']
    assert list(want) == ['name', 'test-set', 'lambdas', 'results']
    assert list(got) == ['name', 'test-set', 'platform', 'device', 'lambdas',
                         'results']
    assert got['lambdas'] == want['lambdas'] == [16, 64]
    assert got['device'] == 'cpu' and got['name'] == want['name']
    for w, g in zip(want['results']['bpp'], got['results']['bpp']):
        assert abs(g / w - 1) <= 0.01
