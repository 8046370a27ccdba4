"""Shared infrastructure for the port's model handles, counterpart of
``lvae_tpu/models/base.py``: a handle pairs an ``nn.Module`` network with
its device, loads the JAX package's weight files, and keeps the fused codecs
of a model family (models/fused_base.py)."""
import contextlib
import math
import struct
from pathlib import Path

import numpy as np
import torch

from lvae_tpu_torch.models import common
from lvae_tpu_torch.models.weights import params_from_flax, read_flax_msgpack
from lvae_tpu_torch.utils import coding


def resolve_device(device=None):
    """None means the card; raises when there is none. Pass 'cpu' to run
    on the CPU explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device is available; pass '
                               "device='cpu' to run on the CPU")
        device = 'cuda'
    return torch.device(device)


@contextlib.contextmanager
def exact_f32():
    """Exact float32, deterministic library convolutions and products for
    the duration, whatever the process's flags; restores them after."""
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm


def torch_dtype(name):
    """A floating dtype's name ('bfloat16', as the JAX package's
    compute_dtype names it) -> the torch dtype."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f'compute_dtype={name!r}: not a floating dtype')
    return dt


def cast_forward(net, compute_dtype, im, *args):
    """net(im, *args) (its training forward), or with compute_dtype
    ('bfloat16') on casts of the image and of its float32 parameters
    through torch.func.functional_call: the float32 parameters stay the
    masters, and the gradient flows back through the casts into them, as
    ``x.astype(cd)`` does under jax.grad (lvae_tpu/models/qarv/model.py:
    418-423). Buffers (the scale tables) stay as they are."""
    if compute_dtype is None:
        return net(im, *args)
    dt = torch_dtype(compute_dtype)
    params = {k: p.to(dt) if p.dtype == torch.float32 else p
              for k, p in net.named_parameters()}
    with cpu_lowp_convs(net.bias.device):
        return torch.func.functional_call(net, params, (im.to(dt),) + args)


@contextlib.contextmanager
def cpu_lowp_convs(device):
    """On the CPU, ATen's own convolution kernels for the duration, in
    place of oneDNN's, whose bf16 forward convolution in torch's CPU build
    is wrong at some shapes (16 -> 16 channels, 4x4 stride 4: a relative
    error of 1.15; ATen's kernel and oneDNN's backward are right). Wraps
    the low-precision forwards (cast_forward, the bf16 codec backbone); a
    no-op on the card."""
    if torch.device(device).type != 'cpu':
        yield
        return
    with common.mkldnn_enabled(False):
        yield


def to_nchw_batch(im, device) -> torch.Tensor:
    """(B,H,W,3), (B,3,H,W) or (H,W,3) image(s) in [0,1] -> float32 NCHW
    batch on `device`."""
    t = torch.as_tensor(np.asarray(im) if not torch.is_tensor(im) else im)
    t = t.to(device=device, dtype=torch.float32)
    if t.ndim == 3:
        t = t[None]
    if t.ndim != 4:
        raise ValueError(f'bad image batch shape {tuple(t.shape)}')
    if not (t.shape[1] == 3 and t.shape[3] != 3):     # NHWC, as JAX takes
        t = t.permute(0, 3, 1, 2)
    return t.contiguous()


def host_stats(stats):
    """A forward's stats (0-d tensors, 'mse_im' among them) -> floats,
    pulled in one copy, with 'psnr' in place of 'mse_im'."""
    vals = torch.stack(list(stats.values())).cpu().tolist()
    out = dict(zip(stats, vals))
    out['psnr'] = -10 * math.log10(max(out.pop('mse_im'), 1e-12))
    return out


def host_image(img):
    """(B, H, W, 3) decoded image on the device -> float32 numpy; a uint8
    image (the lossless head's exact pixels) as u8 / 255, as the JAX package
    returns it."""
    a = img.cpu().numpy()
    if a.dtype == np.uint8:
        return a.astype(np.float32) / 255.0
    return a.astype(np.float32)


def nhwc_numpy(x):
    """(B, C, H, W) tensor -> float32 NHWC numpy on the host."""
    return x.permute(0, 2, 3, 1).float().cpu().numpy()


def latents_to_device(latents, device):
    """NHWC numpy latents (None entries kept) -> NCHW float32 tensors."""
    return [None if z is None else
            torch.as_tensor(np.asarray(z, np.float32)).permute(
                0, 3, 1, 2).contiguous().to(device) for z in latents]


def save_sample_grids(model, save_dir):
    """study()'s sample grids: for k = 1, 2 six unconditional samples at
    the default lambda and a (6, k, k) latent grid, side by side, as
    samples_k<k>_hw<H>.png."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    for k in (1, 2):
        ims = model.unconditional_sample(model.default_lmb,
                                         bhw_repeat=(6, k, k))
        grid = np.concatenate(list(ims), axis=1)
        coding.write_png(save_dir / f'samples_k{k}_hw{ims.shape[1]}.png',
                         coding.batch_to_image(grid))
    return save_dir


class VAEModelBase:
    """Owns the network, the device it runs on and its fused codecs. A
    family sets `_coder` (models/entropy_coding.DiscretizedGaussian of its
    scale table) and `codec_classes` (legacy codec, portable codec)."""

    codec_classes = None
    coder_kind = 'fused'

    def __init__(self, net, device):
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()

    @property
    def max_stride(self):
        return self.net.max_stride

    def _lmbs(self, lmb, n):
        """A scalar or per-image lambdas -> (n,) float32 on the device."""
        if not torch.is_tensor(lmb) and np.ndim(lmb) == 0:
            return torch.full((n,), float(lmb), dtype=torch.float32,
                              device=self.device)
        return torch.as_tensor(lmb, dtype=torch.float32, device=self.device)

    def _generator(self, seed, generator=None):
        """`generator`, or a new one on the model's device seeded `seed`."""
        if generator is not None:
            return generator
        return torch.Generator(self.device).manual_seed(seed)

    def num_params(self):
        return sum(p.numel() for p in self.net.parameters())

    def load_weights(self, path):
        """Load a flax msgpack weight file of the JAX package (stored at
        float16 or float32; the port computes in float32), or a file the
        port's training wrote (training/checkpoint.py: a weights file or a
        whole training state, whose parameters are taken)."""
        with open(path, 'rb') as f:
            is_torch = f.read(2) == b'PK'          # torch.save's zip
        if is_torch:
            from lvae_tpu_torch.training.checkpoint import read_weights
            sd = read_weights(path)
        else:
            sd = params_from_flax(read_flax_msgpack(path), self.net)
        self.net.load_state_dict(sd, strict=True)

    def load_pretrained(self, path):
        """Load weights by the file's suffix: a .pt / .pth checkpoint of the
        original PyTorch project (models/port.py), else a flax msgpack file
        of the JAX package (load_weights)."""
        if str(path).endswith(('.pt', '.pth')):
            from lvae_tpu_torch.models import port
            self.net.load_state_dict(port.load_torch_checkpoint(self, path),
                                     strict=True)
        else:
            self.load_weights(path)

    # ---- the fused codecs ------------------------------------------------

    def compress_mode(self, mode=True, coder='fused', num_lanes=128,
                      esc_cap=8192, word_cap=None, portable=False,
                      max_program_batch=None, compute_dtype=None):
        """Prepare entropy coding through one of three coders:

        coder='fused'  the fused codec: the trunk and the rANS kernels on
                       the card in both directions (models/fused_base.py).
                       portable=True codes on the portable trunk
                       (ops/trunk.py kernels): its streams decode in any
                       process.
        coder='host'   per-block native rANS on the host (ops/crans.py) in
                       the JAX package's container, one device round trip
                       a latent block on decode (models/staged.py).
        coder='device' one N = 128 lane stream encoded on the host and
                       decoded by the rANS decode kernel, one launch a
                       latent block (models/staged.py).
        The host and device coders run the legacy fused codec's trunk, so
        their streams decode in the writing process.

        num_lanes (fused): 16/32/64/128 (QARV also 'auto': by lambda).
        word_cap caps the coded stream length in 16-bit words; streams that
        overflow it (or esc_cap escapes) raise OverflowError.
        max_program_batch caps the images coded at once: larger
        compress_batch requests run as balanced chunks.
        compute_dtype='bfloat16' runs the encoder backbone alone in bf16
        (on every coder: the host and device coders run the legacy fused
        codec's encode): its features only choose the symbols written, and
        decode never runs it. The posterior, the lambda embedding, the
        priors, the fuses, the tail and the probability math stay float32.
        Codecs stay cached across calls, keyed by their whole configuration:
        switching f32, bf16 and portable reuses the ones built."""
        if coder not in ('host', 'device', 'fused'):
            raise ValueError(f"coder={coder!r}: 'host', 'device' or "
                             f"'fused'")
        if mode:
            self._coder.update()
            if compute_dtype is not None:
                torch_dtype(compute_dtype)              # checked here
            self._fused_cfg = dict(esc_cap=esc_cap, word_cap=word_cap,
                                   portable=bool(portable),
                                   max_program_batch=max_program_batch,
                                   compute_dtype=compute_dtype)
            self._fused_codecs = getattr(self, '_fused_codecs', {})
            self.coder_kind = coder
            if coder == 'fused':
                self.num_lanes = num_lanes
                self._fused = self._get_fused(
                    num_lanes if num_lanes != 'auto' else 128)
            else:
                self.num_lanes = 128
        self.compressing = mode

    def _staged_codec(self):
        """The legacy fused codec whose trunk the host and device coders
        run (its 128 lanes are the device coder's)."""
        return self._get_fused(128, portable=False)

    def _require_fused(self, what):
        if not self.compressing:
            raise RuntimeError('call compress_mode() first')
        if self.coder_kind != 'fused':
            raise ValueError(f'{what} requires compress_mode(coder='
                             f'"fused"), not coder={self.coder_kind!r}')

    def _get_fused(self, n_lanes: int, portable=None):
        """Codec for (lane count, current cfg); `portable` overrides the
        cfg's trunk kind: decode routes by the stream's marker bit, and
        compress_file writes portable streams by default."""
        cfg = dict(self._fused_cfg)
        if portable is not None:
            cfg['portable'] = bool(portable)
        key = (n_lanes,) + tuple(sorted(cfg.items()))
        codec = self._fused_codecs.get(key)
        if codec is None:
            legacy, portable_kind = self.codec_classes
            kind = portable_kind if cfg.pop('portable') else legacy
            codec = kind(self.net, self._coder.cdf_table, num_lanes=n_lanes,
                         **cfg, **self._codec_tables())
            self._fused_codecs[key] = codec
        return codec

    def _codec_tables(self):
        """Extra CDF tables a family's codec takes (QRes's lossless head)."""
        return {}

    def _stream_codec(self, bodies):
        """The codec of the streams' lane count and trunk kind (the lane
        field's high bit marks a portable stream), whatever compress_mode
        chose: a portable file decodes in any process. All bodies must
        share the field."""
        fields = {struct.unpack('<H', b[8:10])[0] for b in bodies}
        if len(fields) != 1:
            raise ValueError(f'mixed lane counts / trunk kinds in batch: '
                             f'{sorted(fields)}')
        lanes_field, = fields
        return self._get_fused(lanes_field & 0x7FFF,
                               portable=bool(lanes_field & 0x8000))

    # ---- batch serving: a family defines the async dispatch, its finish
    # (the container) and decompress_batch_to_device ------------------------

    def compress_batch(self, ims, *args, **kwargs):
        """Batch encode: B same-shape images (B, H, W, 3) in [0, 1] -> B
        single-image streams in the family's container (the extra arguments
        are compress_batch_async's). The trunk runs the B images at once;
        rANS codes them in one multi-image launch. Portable streams decode
        anywhere, alone or in any batch; legacy ones in this process,
        through decompress_batch at the same max_program_batch."""
        return self.compress_batch_finish(
            self.compress_batch_async(ims, *args, **kwargs))

    def decompress_batch(self, objs):
        """decompress_batch_to_device -> (B, H, W, 3) float32 numpy."""
        return host_image(self.decompress_batch_to_device(objs))

    def _to_input(self, im, batch=False):
        """Image(s) -> NCHW float32 batch on the device, checked as the JAX
        package's _check_input checks them: the stride, one image unless
        `batch`, and values in [0, 1] for host (numpy) input; device tensors
        are not range-checked."""
        if not self.compressing:
            raise RuntimeError('call compress_mode() first')
        return self._checked(im, batch)

    def _checked(self, im, batch=True):
        """_to_input's checks and conversion, without compress_mode (the
        forward pass)."""
        if isinstance(im, np.ndarray) and im.size and not (
                im.min() >= 0.0 and im.max() <= 1.0):
            raise ValueError('input values must be in [0, 1]')
        im = to_nchw_batch(im, self.device)
        s = self.net.max_stride
        if im.shape[0] != 1 and not batch:
            raise ValueError(f'only a single image is supported, got '
                             f'{tuple(im.shape)}; use compress_batch')
        if im.shape[2] % s or im.shape[3] % s:
            raise ValueError(f'input H/W {tuple(im.shape[2:])} must be '
                             f'divisible by {s} (use compress_file)')
        return im
