"""The fused QARV codec of ``lvae_tpu/models/qarv/fused.py``, for single
images and batches, on either trunk.

Encode: lambda embedding -> encoder backbone -> per latent block prior ->
symbols = round(posterior mean - prior mean) -> fuse, with the plain blocks
in between -> escapes, row layout and the CUDA rANS encode kernel -> one
payload pull. Decode: the same trunk with the symbols from the CUDA rANS
decode kernel, then the synthesis tail and clip*0.5+0.5 -> float16.

The trunk runs B images at once, each with its own lambda. A single image
goes through the single-image rANS kernels; a batch (chunk) through the
multi-image ones: one encode launch, and one decode launch per latent block.

Bit-exactness: an arithmetic-coded stream desyncs when the decoder's
recomputed prior floats differ from the encoder's by a single scale-index
flip. Both directions therefore run ONE trunk function (`_trunk`) and differ
only in where the integer symbols come from. Two trunks fill it:

* legacy (``FusedQarvCodec``): the modules' cuDNN convolutions and cuBLAS
  products, NCHW, in exact float32 whatever the process's flags
  (``_exact_f32``); a legacy stream decodes bit-exactly in the process (and
  on the card type) that wrote it.
* portable (``PortableQarvCodec``, which overrides the trunk's stages):
  every float between the integer junctions comes from the hand-written
  kernels of ``ops/trunk.py`` (lambda embedding, ConvNeXt-AdaLN blocks,
  priors and scale indexes, fuses, 1x1 convs, pixel finish), on NHWC
  features as the JAX kernels take them; outside them only data movement
  (pad, reshape, pixel shuffle, concatenation). The kernels' results depend
  on nothing but their inputs, so a portable stream decodes in any process:
  it is the file format.

On both trunks the encoder backbone and ``posterior_qm`` stay library
convolutions (NCHW), because their outputs only choose which symbols are
written (lvae_tpu/models/qarv/fused.py:36-41).
"""
import contextlib

import torch
import torch.nn.functional as F

from lvae_tpu_torch.models import common
from lvae_tpu_torch.models.fused_base import FusedCodecBase
from lvae_tpu_torch.models.qarv.model import patch_escapes
from lvae_tpu_torch.ops import cdf as cdf_ops
from lvae_tpu_torch.ops import rans_decode as rd
from lvae_tpu_torch.ops import trunk


@contextlib.contextmanager
def _exact_f32():
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


def pixel_shuffle_nhwc(x, rate):
    """Depth-to-space on NHWC with torch.nn.PixelShuffle's channel order
    (lvae_tpu/models/common.py pixel_shuffle)."""
    B, H, W, CRR = x.shape
    C = CRR // (rate * rate)
    x = x.reshape(B, H, W, C, rate, rate).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * rate, W * rate, C)


_PERMS = {('NCHW', 'NHWC'): (0, 2, 3, 1), ('NHWC', 'NCHW'): (0, 3, 1, 2),
          ('NCHW', 'NCHW'): (0, 1, 2, 3), ('NHWC', 'NHWC'): (0, 1, 2, 3)}


class FusedQarvCodec(FusedCodecBase):
    """Fused codec for VariableRateLossyVAENet (lambda-conditioned) on the
    legacy trunk; PortableQarvCodec overrides the trunk's stages."""

    layout = 'NCHW'                      # of the trunk's features
    # Precision policy around the whole trunk (the JAX package's "encode
    # and decode agree on every trunk float" invariant, held within one
    # process): the legacy trunk is all library calls, so it runs in exact
    # float32 - no TF32 in convolutions (cuDNN's default) or matmuls - with
    # deterministic cuDNN algorithms chosen by shape alone, whatever the
    # process's flags. GELU is the exact erf form and LayerNorm has eps 1e-6
    # and no affine (models/common.py).
    trunk_scope = staticmethod(_exact_f32)

    def __init__(self, net, cdf_table, **cfg):
        super().__init__(net, cdf_table, **cfg)
        blocks = list(net.dec_blocks)
        self.stop = next(i for i, b in enumerate(blocks)
                         if isinstance(b, common.CompressionStopFlag))

    def _to(self, t, layout):
        """A feature of this trunk -> a view in `layout`."""
        return t.permute(_PERMS[self.layout, layout])

    def _from(self, t, layout):
        """A tensor in `layout` -> this trunk's layout, contiguous."""
        return t.permute(_PERMS[layout, self.layout]).contiguous()

    # ---- the trunk's stages -------------------------------------------

    def _emb_ctx(self, lmb):
        """-> (emb for the backbone and posterior, gelu(emb) or None)."""
        return self.net.get_lmb_embedding(lmb), None

    def _start(self, B, nH, nW):
        return self.net.bias.expand(B, -1, nH, nW)           # NCHW

    def _prior(self, blk, feature, emb, gemb):
        """-> (f_mid, pm float32, scale indexes int32), in this layout."""
        f_mid, pm, _, indexes = blk.prior_stage(feature, emb)
        return f_mid, pm, indexes

    def _fuse(self, blk, f_mid, pm, syms, emb, gemb):
        return blk.fuse_stage(f_mid, pm, syms, emb)

    def _plain(self, blk, feature, emb, gemb):
        return (blk(feature, emb) if getattr(blk, 'requires_embedding', False)
                else blk(feature))

    def _finish(self, feature):
        """-> (B, H, W, 3) float16 in [0, 1], NHWC."""
        im = torch.clamp(feature.float(), -1.0, 1.0) * 0.5 + 0.5
        return im.to(torch.float16).permute(0, 2, 3, 1)

    # ---- the shared trunk ---------------------------------------------

    def _trunk(self, lmb, B, nH, nW, symbols_for):
        """Lambda embedding, then per latent block prior -> symbols -> fuse,
        with the plain blocks in between, up to the compression stop.
        lmb: (B,) one lambda per image. symbols_for(block, f_mid, pm,
        indexes, emb) -> symbols in this trunk's layout. Returns (feature,
        (emb, gemb), symbols, indexes), the last two per block as (B, nsym)
        int32 tensors in NHWC order."""
        emb, gemb = self._emb_ctx(lmb)
        feature = self._start(B, nH, nW)
        syms_flat, idx_flat = [], []
        for blk in list(self.net.dec_blocks)[:self.stop]:
            if getattr(blk, 'is_latent_block', False):
                f_mid, pm, indexes = self._prior(blk, feature, emb, gemb)
                # canonical layout: both directions feed the fuse the same
                # contiguous int32 tensor
                syms = symbols_for(blk, f_mid, pm, indexes,
                                   emb).to(torch.int32).contiguous()
                feature = self._fuse(blk, f_mid, pm, syms, emb, gemb)
                syms_flat.append(self._to(syms, 'NHWC').reshape(B, -1))
                idx_flat.append(self._to(indexes, 'NHWC').reshape(B, -1))
            else:
                feature = self._plain(blk, feature, emb, gemb)
        return feature, (emb, gemb), syms_flat, idx_flat

    def _tail(self, feature, ctx):
        for blk in list(self.net.dec_blocks)[self.stop + 1:]:
            feature = self._plain(blk, feature, *ctx)
        return self._finish(feature)

    # ---- the two directions -------------------------------------------

    @torch.no_grad()
    def _encode(self, im, lmb, want_image, batch=False):
        """im: (B, 3, H, W) float32 on the device, lmb (B,) -> (payload,
        image|None); a single image's payload (P,) from the single-image
        rANS kernel, a batch's (B, P) from the multi-image one."""
        B, _, imH, imW = im.shape
        ms = self.net.max_stride
        enc_features = {}

        def posterior_symbols(blk, f_mid, pm, indexes, emb):
            with _exact_f32():
                if not enc_features:   # the backbone, on the trunk's emb
                    enc_features.update(self.net.encode_features(im, emb))
                qm = blk.posterior_qm(self._to(f_mid, 'NCHW'),
                                      enc_features[blk.enc_key], emb)
            qm = self._from(qm, 'NCHW')
            return torch.round(qm.float() - pm.float())

        with self.trunk_scope():
            feature, ctx, syms_flat, idx_flat = self._trunk(
                lmb, B, imH // ms, imW // ms, posterior_symbols)
            image = self._tail(feature, ctx) if want_image else None
        if batch:
            return self.pack_payload_batch(syms_flat, idx_flat), image
        return self.pack_payload([s[0] for s in syms_flat],
                                 [i[0] for i in idx_flat]), image

    def encode(self, im, lmb):
        payload, _ = self._encode(im, lmb, want_image=False)
        return self._payload_to_bytes(payload)

    def encode_check(self, im, lmb):
        """encode() that also returns the image reconstructed from the
        encode-side symbols (NHWC float16 on the device)."""
        payload, img = self._encode(im, lmb, want_image=True)
        return self._payload_to_bytes(payload), img

    @torch.no_grad()
    def _decode(self, states, streams, esc_pos, esc_val, nH, nW, lmb,
                batch=False):
        """states (B, N), streams (B, W), esc_pos/esc_val (B, E), lmb (B,)
        on the device -> (B, H, W, 3) float16 images. A single image
        (batch=False, B = 1) decodes through the single-image rANS kernel,
        a batch through one multi-image launch per latent block."""
        N = self.N
        B = states.shape[0]
        ptr = torch.zeros((B,) if batch else (), dtype=torch.int32,
                          device=self.device)
        carry = {'states': states, 'ptr': ptr, 'start': 0}

        def decoded_symbols(blk, f_mid, pm, indexes, emb):
            _, H, W, Z = self._to(pm, 'NHWC').shape
            flat_idx = self._to(indexes, 'NHWC').reshape(B, -1)
            nsym = flat_idx.shape[1]
            T = max((nsym + N - 1) // N, 1)
            idx_rows = F.pad(flat_idx, (0, T * N - nsym)).reshape(B, T, N)
            if batch:
                vals, carry['states'], carry['ptr'] = (
                    rd.rans_decode_block_multi(
                        idx_rows, carry['states'], carry['ptr'], streams,
                        self.cdfs, self.offsets, nsym, num_lanes=N))
            else:
                vals, carry['states'], carry['ptr'] = rd.rans_decode_block(
                    idx_rows[0], carry['states'], carry['ptr'], streams[0],
                    self.cdfs, self.offsets, nsym, num_lanes=N)
            z = patch_escapes(vals.reshape(B, -1)[:, :nsym], esc_pos, esc_val,
                              carry['start'])
            carry['start'] += nsym
            return self._from(z.reshape(B, H, W, Z), 'NHWC')

        with self.trunk_scope():
            feature, ctx, _, _ = self._trunk(lmb, B, nH, nW, decoded_symbols)
            return self._tail(feature, ctx)


class PortableQarvCodec(FusedQarvCodec):
    """The fused codec on the portable trunk: every float between the
    integer junctions from the kernels of ops/trunk.py, on NHWC features
    (lvae_tpu/models/qarv/fused.py:99-193); its streams carry the portable
    marker and decode in any process."""

    portable = True
    layout = 'NHWC'
    # the kernels' results depend on no flag; only the backbone and
    # posterior (library calls) are scoped, in _encode
    trunk_scope = staticmethod(contextlib.nullcontext)

    def __init__(self, net, cdf_table, **cfg):
        super().__init__(net, cdf_table, **cfg)
        self.table = torch.as_tensor(
            cdf_ops.default_gaussian_scale_table().astype('float32'),
            device=self.device)
        self.freqs = torch.as_tensor(
            trunk.emb_freqs(net.lmb_embed_dim[0], net.sin_period),
            device=self.device)

    def _emb_ctx(self, lmb):
        net = self.net
        e0, e1 = net.lmb_embed_0, net.lmb_embed_1
        return trunk.emb_mlp(lmb, self.freqs, e0.weight.t(), e0.bias,
                             e1.weight.t(), e1.bias, net.sin_period)

    def _start(self, B, nH, nW):
        bias = self.net.bias.reshape(1, 1, 1, -1)
        return bias.expand(B, nH, nW, -1).contiguous()

    def _prior(self, blk, feature, emb, gemb):
        f_mid = trunk.convnext_adaln(feature, blk.resnet_front, gemb)
        B, H, W, C = f_mid.shape
        Z = blk.zdim
        pm, idx = trunk.prior_head(
            f_mid.reshape(B, H * W, C), blk.prior.weight.reshape(2 * Z, C).t(),
            blk.prior.bias, self.table)
        return f_mid, pm.reshape(B, H, W, Z), idx.reshape(B, H, W, Z)

    def _fuse(self, blk, f_mid, pm, syms, emb, gemb):
        B, H, W, C = f_mid.shape
        Z = blk.zdim
        f2 = trunk.fuse_zproj(
            f_mid.reshape(B, H * W, C), syms.reshape(B, H * W, Z),
            pm.reshape(B, H * W, Z), blk.z_proj.weight.reshape(C, Z).t(),
            blk.z_proj.bias).reshape(B, H, W, C)
        return trunk.convnext_adaln(f2, blk.resnet_end, gemb)

    def _plain(self, blk, feature, emb, gemb):
        if isinstance(blk, common.ConvNeXtBlockAdaLN):
            return trunk.convnext_adaln(feature, blk, gemb)
        if isinstance(blk, common.patch_upsample):
            y = trunk.conv1x1(feature, blk.conv)
            return pixel_shuffle_nhwc(y, blk.rate).contiguous()
        if isinstance(blk, common.upsample_nearest):         # data movement
            r = blk.rate
            return feature.repeat_interleave(r, 1).repeat_interleave(r, 2)
        raise NotImplementedError(
            f'portable trunk: unsupported block {type(blk).__name__}')

    def _finish(self, feature):
        return trunk.finish_image(feature)
