#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lvae_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. builds the CUDA kernels (one nvcc call per source of csrc/, started
   together, and one link) and loads them with ctypes;
2. holds both rANS kernels against their plain PyTorch versions on the
   card, at every lane count the main path uses (those that
   num_lanes='auto' picks for the three lambdas: N = 16, 64 and 128) on
   random symbols at qarv_base 512x768 size (about 617k symbols, with tail
   rows and escapes), and times both, with their inputs in L2 (as after
   the stage that wrote them) and pushed out of it, also per dependent row
   (ns_per_row); the encode also byte for byte against its row-sync
   oracle kernel (the _rowsync entry points), with the oracle's time
   (rowsync_ms), the chain phase's own time (chain_ms) and the chain's
   bound, its rows on parameters already in registers (chain_bound_ms).
   Then the checks of 2 and 5 again with the lossless head's
   128-row table at N = 48 and 100 (B = 3), and the decode kernel, single
   and multi-image, on rans_corner_cases (every lane renormalising, none,
   a stream cut short, nsym ending inside a row, the stream ring wrapped
   with chunk boundaries inside rows) at N = 1, 16, 48, 100 and 128 with
   the four tables of corner_scale_tables, byte for byte against its plain
   versions and B single launches; and the encode on
   rans_encode_corner_cases (every lane renormalising on every row, none,
   empty and tail rows, one row, out-of-range indexes and symbols, the word
   capacity cut inside a row, at 1 and at T * N, and at N = 1 60,007 rows)
   at N = 1, 16, 31, 32, 33, 48, 64, 100 and 128 with the latent and head
   tables: each image against the row-sync kernel, B = 1, 2, 3 and 6
   against the row-sync kernel and B single launches, and the plain
   versions, byte for byte. Then it holds dense, conv_kxk_act, mlp_res,
   dense_act, prior_head, fuse_zproj and res_dense_act, the kernels on the
   tiled product core, bitwise (same_bits) against their oracle on the old
   core (the _oldcore entry points: dense_act_oldcore, for the conv on
   im2col_tapmajor's columns, for mlp_res two calls and the residual;
   prior_head_oldcore, fuse_zproj_oldcore, res_dense_act_oldcore)
   at synthetic ragged shapes: rows 1, 95 and 385, widths 24, 48, 96 and
   2048, input channels 8, 10, 14, 48 and 96 at kernel sizes 1, 3 and 5,
   act on and off, dense also from unaligned rows; mlp_res at rows 1, 95
   and 385, widths 128, 192, 384 and 512, hidden ratios 1.5 to 4, one output
   width unlike the input's, and once from unaligned rows; dense_act (also
   dense_act_staged) and prior_head at rows 1, 95, 385 and 6144, depths 10 to 512, widths 24 to
   2048 (prior_head: Z 1 to 192), act on and off, aligned and unaligned
   rows, a NaN/inf row and an inf row, and six scale tables (the codecs',
   ties, one entry, 65, shuffled, one past the shared-memory stage);
   fuse_zproj and res_dense_act (both GELU designs) at rows 1 to 24576,
   depths 1 to 96 (1, 10 and 14: the 4-byte copies), widths 24 to 2048,
   aligned and unaligned inputs, symbols up to +-(2^24 - 1), NaN/inf rows
   in pm, t and the feature, -0 in the feature. Then
   it holds dw_ln_mod and dw_ln_affine, the depthwise stencil pair on the halo-tile
   kernel, bitwise against the warp-per-pixel kernel (the _warp entry
   points) at synthetic ragged shapes: H and W of 1, 3, 5, 13 and 130, C of
   8, 40, 128, 200, 384 and 512, K of 1, 3, 5, 7, 9 and 31 (in bands of
   tap rows), and at 13 x 130 a B = 2 input 4 bytes off 16-byte alignment.
   Then it holds emb_mlp's thread-block cluster kernel bitwise against the
   one-block kernel it replaced (emb_mlp_oneblock) at widths 32, 256, 34 x
   36, 6 x 5 and 2048 (weights past shared memory), B = 1, 2, 6, 7 and 200
   (rows in chunks at 256 and 2048), clusters of 8 and 16 CTAs, and zadd_conv_kxk
   (z_proj_0 with the integer junction on its staged taps) bitwise against
   zadd then conv_kxk_act(act=False) at qres34m's four z_proj_0 shapes (B =
   1, 2 and 6) and on H and W of 1 to 13 with Z of 1 to 17, symbols up to
   +-(2^24 - 1), -0, NaN and +-inf in pm, and unaligned inputs, with the
   fused conv and its plain version each within the float32 rounding bound
   of the float64 value (f64_witness); and times emb_mlp at qarv_base's
   widths, B = 1 and 6, at both cluster sizes beside the one-block kernel.
   Then it holds nll_head's search bitwise against the linear count it
   replaced (nll_head_linear) and its plain version (pm and indexes) at
   table sizes 1 to 1024 (NLL_S) on exp-linspace tables, tables with a
   scale at, one ulp below and one ulp above every entry, tied tables,
   raw scales +inf, NaN, overflowing and -inf, from aligned inputs (the
   16-byte path), n % 4 != 0 and inputs 4 bytes off 16; and zadd_dense on
   the tiled core bitwise against zadd_dense_oldcore at rows 1 to 576, Z
   1, 3, 16 and 17, widths 1, 48 and 50, aligned and unaligned inputs.
   Then it holds upsample_finish (the tail's last 1x1 conv, the pixel
   shuffle, the finish and the float16 rounding in one launch) and
   upsample_head (the lossless head's two 1x1
   convs and shuffles in one launch) bitwise against the chains of
   launches they replaced (upsample_finish_chain, upsample_head_chain) on
   grids of 1 to 49,152 rows, B = 1, 2 and 6 (each image against its bits
   alone), C = 8, 10, 128 and 192, rates 1 to 4, rows 4 bytes off 16,
   float16 ties, +-1, NaN and +-inf (shuffle_args);
3. runs qarv_base with the committed weights on images/photo1_512x768.png
   through compress_file / decompress_file at lambda 16, 512 and 2048, on
   the legacy trunk and on the portable trunk (the main path: files are
   portable streams), plus images/hopper_576x512.png at 512 (portable);
   counts every kernel's launches in each call, checks that decoding is
   bit-exact against the encode side's reconstruction, that each file
   equals the one written with the row-sync encode kernel swapped in, and
   that rate and quality match the JAX package's recorded results;
4. holds the seven portable-trunk kernels (upsample_finish within one
   float16 ulp more) against their plain versions on
   the inputs the main path gives them (captured from one encode and
   decode of each image, every distinct shape), checks that a batch of two
   gives the first image the bits it gets alone, holds dense, mlp_res,
   prior_head and fuse_zproj bitwise against the old core (as at every
   later captured shape, for every kernel of CORE_NAMES, at B = 1 and B =
   2), dw_ln_mod (as dw_ln_affine later) against the warp-per-pixel
   kernel and emb_mlp and upsample_finish (as zadd_conv_kxk and
   upsample_head later) against the design it replaced (REDESIGN_ORACLES:
   oracle_ms; emb_mlp's portable cluster of 8 CTAs, cluster8_ms;
   upsample_finish at lambda 16 and 512 too; zadd_conv_kxk's conv alone,
   conv_alone_ms), finish_image on
   upsample_finish's shuffled conv outputs, and times each
   kernel, its plain version, for the kernels of
   OLD_CORE_TIMED the old core (old_core_ms), for prior_head its product
   alone (product_ms: dense_act_staged on the same inputs), for dense_act
   with its GELU pre-pass the one-launch design with the GELU on the staged
   tile (staged_gelu_ms: dense_act_staged), for res_dense_act the GELU
   pre-pass design it does not take (prepass_ms), for fuse_zproj
   and res_dense_act torch.addmm(feature, a, w) on the operand computed
   beforehand (addmm_ms), for the stencil pair the warp-per-pixel kernel
   (warp_oracle_ms) and the two-call yardstick F.conv2d(groups=C) +
   F.layer_norm (two_calls_ms), for dense torch.addmm (device times from
   CUDA-graph replays, and the eager wrapper's time beside them); each
   qarv decode also reports its
   rANS decode launches' time and share of dec_ms, as the qres34m and
   lossless phases do;
5. holds the two multi-image rANS kernels against their plain versions and
   against B single-kernel launches at N = 16, 64 and 128 and B = 2, 3 and
   6, on random symbols at qarv_base size (the same block layout for every
   image, other symbols), and times them as in 2, beside the single
   launches;
6. serves batches on the portable trunk (the batch main path): one B = 6
   request of photo1..3 at lambda 776.05 and 2048 through compress_batch /
   decompress_batch, bit-exact against encode_check_batch, with each
   lambda's mean rate and PSNR held against the JAX package's recorded
   sweep, the bodies equal to those of the row-sync encode kernel; a batch
   stream decoded alone and single streams decoded as a
   batch, bitwise; the request split [3, 3] by max_program_batch=4; the
   seven trunk kernels held against their plain versions as in 4 on the
   inputs of that request at B = 6 and at B = 3 (every distinct shape); the
   dispatch run under torch.cuda.set_sync_debug_mode('error') on both
   trunks; and the launches of each call counted;
7. runs qres34m at full width (random weights from a seeded generator,
   each prior's last conv re-drawn, N = 128, esc_cap 1 << 18) on photo1 on
   the portable trunk: compress_file / decompress_file and compress /
   decompress bitwise against compress_check's reconstruction, with every
   call's launches checked against the block list; a legacy-trunk round
   trip; a B = 2 request (photo1, photo2) bitwise against
   encode_check_batch, each batch stream alone and single streams as a
   batch; the six QRes kernels, and the four kernels it shares with qarv,
   held against their plain versions at every shape of one encode and
   decode (B = 1 against B = 2 bitwise, CUDA-graph, plain and library
   times), and zadd, off the main path since z_proj_0 runs as
   zadd_conv_kxk, on the (syms, pm) of zadd_conv_kxk's calls (zadd_oracle);
   zadd_dense bitwise against the old core and upsample_finish against
   its chain also at the B = 2 request's shapes, each image against its
   bits alone (hold_redesigns);
   bench.py's qres34m enc_ms / dec_ms on both trunks; then, with
   one channel of the last latent block's posterior scaled x3000 so that
   escapes occur, a portable, a legacy and a B = 2 round trip bitwise;
8. runs qres34m_lossless at full width (random weights as in 7, N = 128,
   esc_cap 1 << 21, more than an image's symbols) on photo1:
   compress_file / decompress_file on the portable trunk, the PNG's pixels
   back exactly; compress / decompress bitwise against compress_check; a
   legacy round trip; the B = 2 request as in 7; every call's launches
   against the block list (the head: its two 1x1 convs as one
   upsample_head launch, nll_head, and on decode nll_recon and a 13th rANS
   decode launch); nll_head, nll_recon, upsample_head (also bitwise
   against its chain) and the trunk's dense, mlp_res, dense_act,
   prior_head and res_dense_act held against their plain versions at
   every shape of one encode and decode (the last five also against the
   old core),
   nll_head and nll_recon bitwise (also on
   photo1-sized synthetic inputs covering the head's table and the pixel
   grid's half-points), B = 1 against B = 2 bitwise, with their times
   (nll_head beside nll_head_linear, oracle_ms, and the count alone by
   torch.searchsorted, search_library_ms; zadd_dense beside the old core);
   nll_head, zadd_dense and upsample_head bitwise against their oracles
   also at the shapes of the B = 2 request and of the spread crop below;
   the
   head block's rANS decode time beside the latent blocks'; enc_ms /
   dec_ms on both trunks; and a 256x256 crop with the head's scales spread
   over its table (conv_scale re-drawn from the measured spread of its raw
   outputs), exact, with escapes and at least 64 distinct head indexes;
   then decodes the golden portable streams of tests/golden/ (written on
   the card by an earlier commit: qarv_base photo1 at lambda 2048 and
   qres34m_lossless on the 256 crop) with decompress_file and requires
   the recorded sha256 of the float16 image and of the exact pixels;
9. decodes photo1's qarv portable file, one qarv batch stream as a file,
   the qres34m file and the qres34m_lossless file (their weights saved to
   the temporary directory) in a fresh python3 process with TF32 and
   cudnn.benchmark on, and checks the pixels bitwise (the lossless file's
   against the PNG's);
10. the eval harness (run_eval): python -m lvae_tpu_torch.eval_var_rate
   on qarv_base with the committed weights over photo1..3 at six lambdas
   (16 to 2048, compress_mode()'s 128 lanes, as the JAX package's sweep
   ran), in a process of its own and in a temporary working directory;
   its lambdas, and each lambda's bpp within 2 % and PSNR within 0.2 dB,
   held against the JAX package's sweep (runs/results/realphotos-r5mix-
   qarv_base.json), the BD-rate against that curve reported; the last
   lambda's sweep again in this process through
   evaluation.imcoding_evaluate, its kernel launches counted, its numbers
   equal to the CLI's; QarvModel.self_evaluate over the same photos (its
   estimated bpp beside the files'), and the forward on photo1 at lambda
   16 and 2048 on the card against the same weights on the CPU (bpp rtol
   1e-3, PSNR 0.01 dB, exact float32 both); then qres34m and
   qres34m_lossless (seeded as in 7 and 8) through imcoding_evaluate with
   two shape buckets on photo1 and its 256x256 crop (launches counted;
   the lossless files exact, mse 0) and image_self_evaluate on the card
   against the CPU;
11. the host coder (compress_mode(coder='host'): per-block native rANS on
   the host, g++-built csrc/crans.cpp, the legacy trunk): qarv_base with the
   committed weights on photo1 at lambda 2048, qres34m and
   qres34m_lossless (seeded as in 7 and 8): each round trip exact, the
   reconstruction bitwise the legacy fused N = 128 compress_check's (the
   lossless pixels exact), qarv_base's bpp within 2 % of that legacy
   stream's (the other two printed: random weights), no kernel launched
   but the host's; encode and decode medians;
12. the device coder (coder='device': the stream encoded on the host by
   the native N-lane encoder, decoded by kernel #1, rans_decode_block):
   qarv_base and qres34m as in 11, the decode bitwise the legacy fused and
   host ones, kernel #1 launched once a latent block (9 and 12) and those
   launches timed with their bound; qres34m_lossless refused;
13. qres17m at full width (seeded as in 7; its deconvs ConvTranspose2d on
   the legacy trunk) on photo1: the legacy fused round trip exact at B = 1
   and B = 2 (photo1, photo2) with kernels #1-#4's launches counted and
   timed with their bounds; each image's lane states, words and escapes in
   the B = 2 bodies equal to the native N-lane encoder's on its symbols
   (multi_encode_witness), on the seeded weights and again with the last
   latent block's posterior channel 0 x3000 (escapes in both images, that
   round trip exact too); the host, device and legacy fused
   reconstructions bitwise equal; compress_mode(portable=True) and
   compress_file() in fused mode refused (no deconv kernel); bpp, PSNR and
   bench.py's enc/dec ms;
14. with TF32 off (exact_f32), the paths that run no kernel of csrc/
   (library convolutions and products): rd_model_base at full width
   (run_rd: seeded random weights; unscaled, the crop's KL must be inf;
   then its z projections scaled by ZPROJ_SCALE) with the JAX tree's
   parameter count, its training forward on photo1 at lambda 4, 64 and
   2048 (ms, peak memory, FlopCounterMode's operations and their bound),
   card against CPU on the 256x256 crop on CPU-drawn noise (bppix and loss
   rtol 1e-4, PSNR 1e-3 dB), unconditional samples (finite, in [0, 1],
   bitwise again), t = 0 card against CPU and study()'s PNGs; the sampling entry points (run_sampling): qarv_base
   and qres34m (unscaled, a prior sample must hold NaN; then scaled as
   rd_model_base), the decoder on forward_get_latents' z against the
   reconstruction (within 1e-5; bitwise expected), t = 0 samples card
   against CPU (1e-4), qres34m's two-step inpaint on the crop (finite,
   bitwise again); and the original project's checkpoint format
   (run_torch_checkpoint): qarv_base's weights written as a .pt under
   models/port.py's keys, loaded by get_model(pretrained=...), its state
   dict and photo1's portable stream at lambda 2048 bitwise the
   msgpack-loaded model's;
15. the bf16 encoder backbone (run_bf16_codec, before 9, whose fresh
   process also decodes its two bf16 portable files):
   compress_mode(compute_dtype='bfloat16') on qarv_base (committed
   weights, photo1 at lambda 512 and 2048, both trunks) and qres34m (7's
   weights, photo1, portable): B = 1 and B = 2 round trips bitwise, the
   encode's kernel launches equal to float32's, bpp and PSNR beside
   float32's (qarv_base within 2 % and 0.2 dB), enc_ms of both in turns;
16. training (run_train, last): python -m lvae_tpu_torch.train_var_rate's
   main() on qarv_base from the committed weights, images/ as training and
   validation set, crop 256, batch 16, Adam at 2e-4, 6 steps each at
   float32, --amp, --amp --remat and float32 with --device_data, then a
   --resume for 2 steps; train_fix_rate on qres34m (7's weights; z
   projections scaled by ZPROJ_SCALE where the unscaled step-0 loss is
   not finite), 3 steps: every step's loss and grad norm finite, the step
   time (host clock, and the step alone by CUDA events), a step's
   operations (3 forwards by FlopCounterMode, 4 with --remat) and their
   bound, peak memory, the checkpoint files.
17. multi-GPU (lvae_tpu_torch/parallel/; one card, so NCCL runs at world
   size 1 and several ranks share cuda:0 over gloo): dp_nccl1, the float32
   run of 16 again in a process group of one on NCCL (the step's
   all_reduce runs), its parameters bitwise the run's without one; then
   torchrun starts DIST_RANKS ranks of this script (--rank-phases, gloo
   on cuda:0): dp_gloo2, two ranks of 8 crops against one process's 16,
   spatial, spatial_eval of qarv_base on photo1 (lambda 512) at 1x2 and
   1x4 and of qres34m (7's random weights) at 1x2 against the
   unsharded forward (SPATIAL_RTOL), with the halo exchange's time and
   share, and dp_sp, the 2x2 (data, space) step at batch 4 against one
   process's; each step's ranks bitwise equal, its loss and first
   averaged gradient held against one process (DIST_LOSS_RTOL, DIST_ATOL;
   the parameters' gap after two Adam steps reported), the gradient
   all-reduce's time; then NCCL at two ranks on the one card, its refusal
   recorded, not required.

Standard output: one JSON object per line (build, card (the card's name,
power limit, driver version, nvcc's version, torch and its CUDA),
multi_kernels,
rans_decode_checks, rans_encode_checks, tiled_core, dw_tile, emb_zadd,
nll_zadd, shuffle, codec, trunk, batch, qres,
qres_trunk, lossless, lossless_trunk, golden, fresh_process, eval,
bf16_codec, host_coder, device_coder, qres17m, rd, sampling,
torch_checkpoint, train, dp_nccl1, dp_gloo2, spatial, dp_sp,
nccl_two_ranks, seconds), the card line of nvidia-smi, the
kernels line (the rANS kernels' entries with their new_paths: the device
coder's and qres17m's launches, times and bounds), then the result line.
Progress goes to standard error. Any failure raises and exits non-zero;
without a CUDA card the script exits 1 before printing any result.
"""
import contextlib
import json
import math
import os
import pickle
import shutil
import signal
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, 'checkpoints',
                          'qarv_base_mixed20k_ema_f16.msgpack')
PHOTO = os.path.join(ROOT, 'images', 'photo1_512x768.png')
HOPPER = os.path.join(ROOT, 'images', 'hopper_576x512.png')
PHOTOS = [os.path.join(ROOT, 'images', f'photo{i}_512x768.png')
          for i in (1, 2, 3)]
# the JAX package's sweep over photo1..3 (eval-var-rate.py, one
# compress_mode() at N = 128): each lambda's mean bpp and PSNR gate the batch
SWEEP = os.path.join(ROOT, 'runs', 'results',
                     'realphotos-r5mix-qarv_base.json')
BATCH_LAMBDAS = (776.0468820533245, 2048.0)
SERVING_B = 6                                      # bench.py:418-466
LAMBDAS = (16.0, 512.0, 2048.0)
# the JAX package's results (runs/suite4-r5mix.json): (bpp, PSNR dB); the
# photo1 ones gate the run, hopper's is reported beside the port's
REFERENCE = {(PHOTO, 512.0): (1.4931, 35.76), (PHOTO, 2048.0): (1.811, 36.22)}
REPORTED = {(HOPPER, 512.0): (1.7628, 36.62)}
BPP_REL_TOL, PSNR_TOL_DB = 0.02, 0.2
# kernel launches per image, by trunk (lvae_tpu/models/qarv/zoo.py:55-89):
# encode runs the trunk to the compression stop (emb, 24 ConvNeXt blocks =
# 24 dw_ln_mod + 24 mlp_res, 3 upsample convs, 9 priors and fuses: 70
# trunk launches) and the rANS encode; decode adds the tail (9 ConvNeXt
# blocks, 1 upsample conv, the last conv with the finish as
# upsample_finish: 90) and decodes 9 latent blocks
QARV_TRUNK = ('emb_mlp', 'dw_ln_mod', 'mlp_res', 'dense', 'prior_head',
              'fuse_zproj', 'upsample_finish')
# the QRes-VAE trunk's own kernels (it also runs mlp_res, dense, prior_head
# and upsample_finish)
QRES_TRUNK = ('dw_ln_affine', 'dense_act', 'conv_kxk_act', 'zadd_dense',
              'zadd_conv_kxk', 'res_dense_act')
TRUNK_NAMES = QARV_TRUNK + QRES_TRUNK
QRES_PATH_TRUNK = QRES_TRUNK + ('mlp_res', 'dense', 'prior_head',
                                'upsample_finish')
# the lossless pixel head's kernels, held bitwise against their plain
# versions (they decide on which grid value each pixel lands)
LOSSLESS_TRUNK = ('nll_head', 'nll_recon')
# the head's kernels: those two and its two convs in one launch
LOSSLESS_HEAD = ('upsample_head',) + LOSSLESS_TRUNK
TRUNK_NAMES = TRUNK_NAMES + LOSSLESS_HEAD
RANS_NAMES = ('rans_encode_all', 'rans_decode_block',
              'rans_encode_all_multi', 'rans_decode_block_multi')
# counted kernels that run on no main path: zadd (with
# conv_kxk_act(act=False) after it, zadd_conv_kxk's oracle: zadd_oracle)
# and finish_image (with dense and the shuffle before it, upsample_finish's
# oracle: finish_oracle)
OFF_PATH = ('zadd', 'finish_image')
_NONE = dict.fromkeys(RANS_NAMES + TRUNK_NAMES + OFF_PATH, 0)
EXPECTED_LAUNCHES = {
    False: (dict(_NONE, rans_encode_all=1), dict(_NONE, rans_decode_block=9)),
    True: (dict(_NONE, rans_encode_all=1, emb_mlp=1, dw_ln_mod=24,
                mlp_res=24, dense=3, prior_head=9, fuse_zproj=9),
           dict(_NONE, rans_decode_block=9, emb_mlp=1, dw_ln_mod=33,
                mlp_res=33, dense=4, prior_head=9, fuse_zproj=9,
                upsample_finish=1))}
# qres34m (lvae_tpu/models/qresvae/zoo.py:37-92) on the portable trunk, per
# 512x768 image: 12 latent blocks (one at kernel size 1, eleven at 3/5/7),
# each 2 plain ConvNeXt blocks (dw_ln_affine + mlp_res), a prior (dense_act,
# then two 3x3 conv_kxk_act or at size 1 two more dense_act, then
# prior_head) and a fuse (the 3x3 z_proj_0 as zadd_conv_kxk, or
# zadd_dense; then res_dense_act); 4 upsample convs between the stages, and
# on decode the tail's upsample conv with the finish (upsample_finish).
# zadd and finish_image launch nowhere
_QRES = dict(_NONE, dw_ln_affine=24, mlp_res=24, dense_act=14,
             conv_kxk_act=22, prior_head=12, zadd_conv_kxk=11, zadd_dense=1,
             res_dense_act=12, dense=4)
EXPECTED_QRES_LAUNCHES = (
    dict(_QRES, rans_encode_all=1),
    dict(_QRES, rans_decode_block=12, upsample_finish=1))
QRES_SEED = 0
QRES_LANES, QRES_ESC_CAP = 128, 1 << 18     # bench.py:511-518: random init
QRES_PHOTOS = PHOTOS[:2]                     # the B = 2 batch
# qres34m_lossless (lvae_tpu/models/qresvae/zoo.py:95-107): qres34m's blocks
# without the tail's upsample; the head adds its two 1x1 convs (one
# upsample_head launch) a direction and nll_head, on decode nll_recon and
# one more rANS decode launch (the H*W*3 pixel symbols)
_LOSSLESS = dict(_QRES, upsample_head=1, nll_head=1)
EXPECTED_LOSSLESS_LAUNCHES = (
    dict(_LOSSLESS, rans_encode_all=1),
    dict(_LOSSLESS, rans_decode_block=13, nll_recon=1))
# random weights predict no pixel: most pixel symbols may escape, so the
# cap holds every symbol of a photo1 image (1,179,648 head + 840,960 latent)
LOSSLESS_ESC_CAP = 1 << 21
SPREAD_CROP, MIN_HEAD_INDEXES = 256, 64
# a batch chunk launches the portable trunk's kernels as often as one image
# does (on (B, ...) tensors), and the multi-image rANS kernels in place of
# the single-image ones: 1 encode launch and 9 decode launches
EXPECTED_BATCH_LAUNCHES = tuple(
    dict(want, rans_encode_all=0, rans_decode_block=0,
         rans_encode_all_multi=want['rans_encode_all'],
         rans_decode_block_multi=want['rans_decode_block'])
    for want in EXPECTED_LAUNCHES[True])
# trunk kernel vs plain version on the card: |kernel - plain| <= ATOL +
# RTOL * |plain|; the plain products sum in cuBLAS's order, the kernels in
# k order
TRUNK_ATOL, TRUNK_RTOL = 1e-5, 1e-4
# upsample_finish's float16 outputs: the kernel and its plain version round
# float32 values that differ within that tolerance, and where one lies
# near a float16 rounding boundary the two roundings fall one float16 ulp
# apart (2^-11 in [0.5, 1), the image's largest binade); its tolerance
# adds that ulp. Its chain is held bit for bit
HALF_ULP = 2.0 ** -11
# qarv_base 512x768 latent block sizes (1/64 .. 1/8 resolution)
QARV_BASE_BLOCKS = (3072, 12288, 12288, 147456, 147456, 147456,
                    49152, 49152, 49152)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12       # H100 SXM float32 rate outside tensor cores
# the kernels on the tiled product core (csrc/trunk.cu tiled_kernel), held
# bitwise against their oracle on the old core (core_oracle) at every shape;
# those whose old-core oracle is timed beside them (old_core_ms)
CORE_NAMES = ('dense', 'conv_kxk_act', 'mlp_res', 'dense_act', 'prior_head',
              'fuse_zproj', 'res_dense_act', 'zadd_dense')
OLD_CORE_TIMED = ('dense', 'mlp_res', 'dense_act', 'prior_head',
                  'fuse_zproj', 'res_dense_act', 'zadd_dense')
# the synthetic ragged shapes of that check: rows M (a B x H x W grid for
# the conv), widths N, input channels Ci at kernel sizes K (dense: depth
# K*K*Ci), act on and off
CORE_M = {1: (1, 1, 1), 95: (1, 5, 19), 385: (1, 11, 35)}
CORE_N, CORE_CI, CORE_K = (24, 48, 96, 2048), (8, 10, 14, 48, 96), (1, 3, 5)
# mlp_res's synthetic shapes: rows, input widths C, hidden widths HID =
# ratio * C; and one case whose output width CO differs from C
MLP_M, MLP_C, MLP_RATIOS = (1, 95, 385), (128, 192, 384, 512), (1.5, 2, 3, 4)
MLP_CO_CASE = (95, 384, 1536, 192)          # M, C, HID, CO
# a hidden width that is no multiple of 4: fc2 from the 4-byte copies
MLP_HID_RAGGED_CASE = (95, 128, 190, 128)
CORE_SEED = 9
# dense_act's and prior_head's synthetic shapes: rows M, depths C (10: the
# 4-byte copies), dense_act's widths N, prior_head's latent widths Z (2Z
# columns), act on and off, also from rows 4 bytes off 16; prior_head with
# the codecs' table at every shape, with the other tables of prior_tables
# at the PRIOR_TABLE_* subset; two rows of every input with M > 1 are
# non-finite (one NaN, +inf and -inf; one +inf)
DA_M, DA_C, DA_N = (1, 95, 385, 6144), (10, 48, 96, 256, 384, 512), \
    (24, 48, 96, 2048)
PRIOR_Z = (1, 16, 20, 28, 64, 192)
PRIOR_TABLE_M, PRIOR_TABLE_C, PRIOR_TABLE_Z = (95, 385), (10, 96), (1, 20, 64)
# the residual joins' synthetic shapes (fuse_zproj and res_dense_act, both
# GELU designs of the latter): rows M, depths K (Z or Ci; 1, 10 and 14 take
# the 4-byte copies), widths N, from aligned inputs and inputs 4 bytes off
# 16; symbols up to +-(2^24 - 1), escape-sized ones among them; a NaN/inf
# row in pm, in t and in the feature, and -0 in the feature
JUNCTION_M, JUNCTION_K, JUNCTION_N = (1, 95, 385, 6144, 24576), \
    (1, 8, 10, 14, 24, 32, 48, 96), (24, 192, 256, 384, 512, 2048)
JUNCTION_SEED = 12
# the depthwise stencil pair (csrc/trunk.cu dw_tile_kernel), held bitwise
# against the warp-per-pixel kernel (the _warp entry points) at every shape
DW_NAMES = ('dw_ln_mod', 'dw_ln_affine')
# that check's synthetic ragged shapes: H and W each of DW_HW (below K
# too), C of DW_C (some no multiple of 32), K of DW_K (9 and 31 run the
# kernel's run-time-K instantiation, 31 in bands of tap rows: its whole
# halo does not fit); at H x W = 13 x 130 also B = 2 from an input 4 bytes
# off 16 (the 4-byte copies)
DW_HW, DW_C, DW_K = (1, 3, 5, 13, 130), (8, 40, 128, 200, 384, 512), \
    (1, 3, 5, 7, 9, 31)
DW_SEED = 11
# emb_mlp's cluster kernel against its one-block oracle: (E0, E) widths
# (qarv_tiny's 32, qarv_base's 256; 34 x 36 and 6 x 5, ragged against the
# lanes and the cluster, 5 below it; 2048, whose weight rows do not fit in
# shared memory), batch sizes (200: more rows than shared memory holds at
# 256 and 2048, so they run in chunks), clusters of 8 and 16 CTAs, lambdas
# over [1, 8192]
EMB_WIDTHS = ((32, 32), (256, 256), (34, 36), (6, 5), (2048, 2048))
EMB_B = (1, 2, 6, 7, 200)
# the cluster kernel's entries by CTAs: the main path's, the 8-CTA yardstick
EMB_CLUSTERS = {16: 'emb_mlp', 8: 'emb_mlp_cluster8'}
EMB_LAMBDAS = (776.0468820533245, 16.0, 512.0, 2048.0, 1.0, 8192.0, 37.5)
# zadd_conv_kxk against zadd then conv_kxk_act(act=False): qres34m's z_proj_0
# shapes (H, W, Z) at B of ZCONV_B and Co of ZCONV_CO, then every H and W of
# ZCONV_HW (below 3 too) with Z of ZCONV_Z, and Z % 4 == 0 also from inputs
# 4 bytes off 16 (the 4-byte copies); pm holds -0 in every fifth value and,
# where there are two pixels or more, NaN, +inf and -inf in the middle one
ZCONV_MAIN = ((16, 24, 14), (32, 48, 12), (64, 96, 10), (128, 192, 8))
ZCONV_B, ZCONV_CO = (1, 2, 6), (24, 48)
ZCONV_HW, ZCONV_Z = (1, 2, 3, 5, 13), tuple(range(1, 18))
ZCONV_SEED = 15
# nll_head's search against the linear count: table sizes NLL_S (1 entry to
# the kernel's 1024, around the head's 128), NLL_N elements a case
# (nll_search_cases); zadd_dense against the old core: rows ZDENSE_M (the
# main path's 96 and 192 at B = 1 and 2, around them, 576), latent widths
# ZDENSE_Z (1, 3 and 17: the 4-byte copies), widths ZDENSE_CO (48: the main
# path's), from aligned and unaligned inputs
NLL_S = (1, 2, 3, 64, 127, 128, 129, 1000, 1024)
NLL_N, NLL_SEED = 6144, 16
ZDENSE_M, ZDENSE_Z, ZDENSE_CO = (1, 95, 96, 97, 192, 576), (1, 3, 16, 17), \
    (1, 48, 50)
ZDENSE_SEED = 17
# upsample_finish and upsample_head against their chains: (B, H, W) grids
# of M = 1, 95, 385, 24576 and 49152 rows (dispatch_shuffle's three tiles
# at N = 48 and 96) and B = 2 and 6 (tiles straddling grid rows and
# images); input channels (10: the 4-byte copies; and once rows 4
# bytes off 16), rates (4: the models'; 2 and 1 the 16x24 tiles; 3 the
# element-by-element write); zero rows (the output the bias alone: float16
# ties, +-1, NaN, +-inf there) and rows of NaN, +-inf and +-1
SHUFFLE_GRIDS = ((1, 1, 1), (1, 5, 19), (1, 11, 35), (2, 5, 19),
                 (6, 5, 19), (1, 128, 192), (2, 128, 192), (2, 3, 7))
SHUFFLE_C, SHUFFLE_RATES = (8, 10, 128, 192), (4, 2, 1, 3)
SHUFFLE_SEED = 18
SHUFFLE_NAMES = ('upsample_finish', 'upsample_head')
GOLDEN = os.path.join(ROOT, 'tests', 'golden')
# timing: medians of 5 kernel runs; the plain versions are host-bound
# references taking seconds, so theirs are medians of 3, the first of which
# is the run whose output the kernel is compared with
KERNEL_REPEATS, PLAIN_REPEATS = 5, 3
# trunk kernels: medians of 5 timings of 10 launches, captured in a CUDA
# graph (device time) and eager (host launch time included); plain
# versions, in a CUDA graph: of 3 timings of 3 calls
TRUNK_INNER, TRUNK_PLAIN_INNER = 10, 3


def elapsed():
    return round(time.perf_counter() - T0, 3)


def emit(obj):
    print(json.dumps(dict(obj, elapsed_s=elapsed())), flush=True)


def progress(msg):
    print(f'[{elapsed():8.1f}s] {msg}', file=sys.stderr, flush=True)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def timed(torch, fn):
    """(fn(), its time in ms from CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_times(torch, fn, repeats, first_ms=None):
    """`repeats` CUDA-event timings of fn() (ms), sorted, counting an
    already measured first run when `first_ms` is given."""
    times = [] if first_ms is None else [first_ms]
    while len(times) < repeats:
        times.append(timed(torch, fn)[1])
    return sorted(times)


def cuda_ms(torch, fn, repeats, first_ms=None):
    """Median of cuda_times."""
    times = cuda_times(torch, fn, repeats, first_ms)
    return times[len(times) // 2]


def cold_l2_ms(torch, fn, repeats):
    """Median of `repeats` CUDA-event timings of fn(), each after a 64 MiB
    fill that pushes fn's inputs out of the card's 50 MB L2 cache."""
    flush = torch.empty(16 << 20, dtype=torch.int32, device='cuda')
    times = []
    for i in range(repeats):
        flush.fill_(i)
        times.append(timed(torch, fn)[1])
    return sorted(times)[len(times) // 2]


def random_blocks(np, seed, N, scales=None):
    """qarv_base-sized symbols: per block scale indexes (into `scales`, by
    default the latent table's 64), values drawn at 1.5x their scale, 1%
    escapes; block sizes cut by a few symbols so that every block ends in a
    partial (tail) row."""
    from lvae_tpu_torch.ops import cdf
    rng = np.random.default_rng(seed)
    if scales is None:
        scales = cdf.default_gaussian_scale_table()
    vals, idxs = [], []
    for b, size in enumerate(QARV_BASE_BLOCKS):
        size -= 1 + (7 * b) % (N - 1)
        idx = rng.integers(0, len(scales), size).astype(np.int32)
        v = np.round(rng.normal(0, scales[idx] * 1.5)).astype(np.int32)
        esc = rng.random(size) < 0.01
        v[esc] = rng.integers(-500, 500, int(esc.sum()))
        vals.append(v)
        idxs.append(idx)
    return vals, idxs


def plain_row_ends(torch, cdfs, offsets, case):
    """The word pointer before each row of image 0 of a rans_corner_cases
    case and after its last: the plain decode run a row at a time."""
    from lvae_tpu_torch.ops import rans_decode as rd
    ix, stream = case['indexes'][0], torch.from_numpy(case['streams'][0])
    cdfs, offsets = torch.from_numpy(cdfs), torch.from_numpy(offsets)
    T, N = ix.shape
    state = torch.from_numpy(case['states'][0][None])
    ptr = torch.tensor(int(case['ptrs'][0]), dtype=torch.int32)
    ends = [int(ptr)]
    for t in range(T):
        _, state, ptr = rd.rans_decode_block_plain(
            torch.from_numpy(ix[t:t + 1]), state, ptr, stream, cdfs, offsets,
            min(max(case['nsym'] - t * N, 0), N))
        ends.append(int(ptr))
    return ends


def rans_ring():
    """The decode kernel's stream ring, read from its source (csrc/rans.cu
    kRingChunk, kRingChunks): (words a chunk, words in all)."""
    import re
    with open(os.path.join(ROOT, 'lvae_tpu_torch', 'csrc', 'rans.cu')) as f:
        src = f.read()
    chunk, chunks = (int(re.search(rf'constexpr int {n} = (\d+);',
                                   src).group(1))
                     for n in ('kRingChunk', 'kRingChunks'))
    return chunk, chunk * chunks


# lane counts of the corner cases (every lane count the kernel's two paths
# take: one warp, a ragged last warp, whole warps)
CORNER_LANES = (1, 16, 48, 100, 128)
# lane counts of the plain-version and single-launch checks with the
# lossless head's table
HEAD_TABLE_LANES = (48, 100)


def corner_scale_tables():
    """The scale tables of the decode's corner cases, by label: the latent
    table (64 rows of 249 CDF entries), the lossless head's (128 rows), the
    latent table's first 40 rows (37 entries: rows shorter than the
    kernel's 256) and 16 scales up to 40 (493 entries: rows padded to 1024,
    the search's extra round)."""
    from lvae_tpu_torch.ops import cdf
    return {'latent': cdf.default_gaussian_scale_table(),
            'head': cdf.lossless_head_scale_table(),
            'narrow': cdf.default_gaussian_scale_table()[:40],
            'wide': cdf.default_gaussian_scale_table(n=16, hi=40.0)}


def rans_corner_cases(np, cdfs, offsets, N, seed=0):
    """Decode inputs at the rANS decode kernel's corners (its stream
    ring's chunk boundaries and wrap, from rans_ring), for a sentinel-padded
    table (cdfs (S, L), offsets (S,): prepare_device_cdf) and N lanes: [(name,
    case)], each case two images of one shape, numpy int32 indexes (2, T, N),
    states (2, N), ptrs (2,), streams (2, W), and nsym. Any states and words
    decode to something, so a case needs no encoder: the kernel must give its
    plain version's bytes. Image 0 is the corner (checked here with
    plain_row_ends), image 1 random states, indexes, pointer and words of the
    same shape. Stream words carry garbage above their 16 bits (the decode
    masks them).
    - every_lane_renormalises: states 2^16 (slot 0: the first symbol, of
      freq < 2^16), so row 0 takes N words, from a pointer N // 2 words
      before a ring chunk boundary (the row's words cross it);
    - no_lane_renormalises: states 0xFFFF8000 (slot 0x8000, the central
      symbol of freq >= 2 times 0xFFFF), so row 0 takes none;
    - stream_cut_short: W ends a few words past the pointer; later rows
      read past W (0);
    - ends_mid_row: nsym ends inside the last row (for N = 1 one row early);
    - ring_wraps: every index the widest scale, rows enough that the words
      wrap the ring at least twice and cross chunk boundaries inside rows
      (N >= 16; fewer at N = 1, where a row takes one word at most)."""
    import torch
    rng = np.random.default_rng(seed + 1000 * N + len(cdfs))
    chunk, ring = rans_ring()
    S = len(cdfs)
    full = np.int64(1) << 32

    def words(W):
        return rng.integers(0, 1 << 31, W).astype(np.int32)

    def random_states():
        return rng.integers(1 << 16, full, N).astype(np.uint32).view(
            np.int32)

    def case(T, ix0, x0, ptr0, W, nsym):
        return dict(
            indexes=np.stack([ix0, rng.integers(0, S, (T, N))]).astype(
                np.int32),
            states=np.stack([np.full(N, x0, np.uint32).view(np.int32)
                             if np.isscalar(x0) else x0, random_states()]),
            ptrs=np.array([ptr0, rng.integers(0, chunk)], np.int32),
            streams=np.stack([words(W), words(W)]), nsym=nsym)

    def random_ix(T):
        return rng.integers(0, S, (T, N))

    T = 12
    # the widest scale's words a symbol (its entropy / 16 bits): rows
    # enough for three ring wraps, at most 3000
    widest = cdfs[S - 1][cdfs[S - 1] <= 1 << 16].astype(np.float64)
    p = np.diff(widest) / (1 << 16)
    per_symbol = -(p[p > 0] * np.log2(p[p > 0])).sum() / 16
    T_wrap = int(min(max(3 * ring / (per_symbol * N), T), 3000))
    ptr0 = chunk - N // 2
    cases = [
        ('every_lane_renormalises',
         case(T, random_ix(T), 1 << 16, ptr0, ptr0 + T * N + 64, T * N)),
        ('no_lane_renormalises',
         case(T, random_ix(T), 0xFFFF8000, 5, T * N + 64, T * N)),
        ('stream_cut_short',
         case(T, random_ix(T), 1 << 16, 3, 3 + max(N // 2, 1), T * N)),
        ('ends_mid_row',
         case(T, random_ix(T), random_states(), 7, T * N + 64,
              T * N - N // 2 - 1)),
        ('ring_wraps',
         case(T_wrap, np.full((T_wrap, N), S - 1), random_states(), ptr0,
              T_wrap * N + 64, T_wrap * N))]
    for name, c in cases:
        ends = plain_row_ends(torch, cdfs, offsets, c)
        counts = np.diff(ends).tolist()
        W = c['streams'].shape[1]
        crossing = any(a // chunk < (b - 1) // chunk
                       for a, b in zip(ends[:-1], ends[1:]) if b > a)
        ok = {'every_lane_renormalises': counts[0] == N and (N < 2
                                                             or crossing),
              'no_lane_renormalises': counts[0] == 0,
              'stream_cut_short': ends[-1] > W,
              'ends_mid_row': c['nsym'] % N != 0 or N == 1,
              'ring_wraps': N < 16 or (ends[-1] - ends[0] >= 2 * ring
                                       and crossing)}[name]
        if not ok:
            raise AssertionError(f'rans_corner_cases N={N} S={S}: {name} '
                                 f'misses its corner (words {counts[:4]}, '
                                 f'{ends[-1] - ends[0]} in all)')
    return cases


def check_kernels(torch, np, table, device, lane_counts):
    """Both kernels against their plain versions at each lane count, on
    qarv_base-sized symbols over the table's scales; each kernel's rows
    (dependent steps: the decode's nine launches' rows, the encode's T) and
    its time a row."""
    from lvae_tpu_torch.ops import rans_decode as rd, rans_encode as re_
    cdfs_np, offs_np = rd.prepare_device_cdf(table)
    cdfs = torch.as_tensor(cdfs_np, device=device)
    offs = torch.as_tensor(offs_np, device=device)
    S, L = cdfs_np.shape
    results = {'rans_encode_all': {}, 'rans_decode_block': {}}
    for N in lane_counts:
        vals, idxs = random_blocks(np, 1234 + N, N, table.scale_table)
        sym_rows, idx_rows, row_n = re_.blocks_to_rows(vals, idxs, N)
        T = sym_rows.shape[0]
        nsym = int(sum(v.size for v in vals))
        inband, esc = re_.prepare_inband(
            torch.as_tensor(sym_rows, device=device),
            torch.as_tensor(idx_rows, device=device), offs,
            torch.as_tensor(table.cdf_lengths, device=device))
        idx_t = torch.as_tensor(idx_rows, device=device)
        row_n_t = torch.as_tensor(row_n, device=device)
        active = (torch.arange(N, device=device)[None, :]
                  < row_n_t[:, None].long())
        n_esc = int((esc & active).sum())
        n_tail = int((row_n < N).sum())
        require(n_esc > 0 and n_tail == len(vals),
                f'N={N}: test data lacks escapes or tail rows')

        # ---- encode
        def enc_kernel():
            return re_.rans_encode_all(inband, idx_t, row_n_t, cdfs,
                                       num_lanes=N)

        def enc_plain():
            return re_.rans_encode_all_plain(inband, idx_t, row_n_t, cdfs)

        got = enc_kernel()
        want, enc_plain_ms = timed(torch, enc_plain)
        enc_err = max(int((a.long() - b.long()).abs().max())
                      for a, b in zip(got, want))
        enc_match = all(torch.equal(a, b) for a, b in zip(got, want))
        pairs, n_words, states = got
        n_words = int(n_words)
        progress(f'rans_encode_all N={N}: T={T} nsym={nsym} '
                 f'words={n_words} escapes={n_esc} match={enc_match}')

        # ---- decode the stream the encode kernel wrote, block by block
        words = re_.pairs_to_words(pairs.cpu().numpy(), n_words)[::-1]
        stream = torch.as_tensor(words.astype(np.int32), device=device)
        blocks = []
        for ix in idxs:
            Tb = max((ix.size + N - 1) // N, 1)
            rows = np.zeros(Tb * N, np.int32)
            rows[:ix.size] = ix
            blocks.append((torch.as_tensor(rows.reshape(Tb, N),
                                           device=device), ix.size))

        def dec_run(fn, keep=True):
            """The nine block launches; the values are kept and joined
            only where compared (the join would push the next timed
            run's indexes out of L2)."""
            st = states
            p = torch.zeros((), dtype=torch.int32, device=device)
            outs = []
            for rows, n in blocks:
                v, st, p = fn(rows, st, p, stream, cdfs, offs, n)
                if keep:
                    outs.append(v)
            return (torch.cat(outs) if keep else None), st, p

        def dec_kernel(keep=False):
            return dec_run(lambda *a: rd.rans_decode_block(*a, num_lanes=N),
                           keep)

        def dec_plain():
            return dec_run(rd.rans_decode_block_plain)

        got = dec_kernel(keep=True)
        want, dec_plain_ms = timed(torch, dec_plain)
        dec_err = max(int((a.long() - b.long()).abs().max())
                      for a, b in zip(got, want))
        dec_match = all(torch.equal(a, b) for a, b in zip(got, want))
        # decoding gives back what encode coded: in-band symbol + offset
        expect = torch.where(active, inband + offs[idx_t], 0)
        roundtrip = (torch.equal(got[0], expect)
                     and int(got[2]) == n_words)
        progress(f'rans_decode_block N={N}: match={dec_match} '
                 f'roundtrip={roundtrip}')
        require(enc_match, f'rans_encode_all N={N} disagrees with its plain '
                           f'version (max abs err {enc_err})')
        require(dec_match, f'rans_decode_block N={N} disagrees with its '
                           f'plain version (max abs err {dec_err})')
        require(roundtrip, f'rans_decode_block N={N} does not give back the '
                           f'encoded symbols')

        table_bytes = 4 * (S * L + S)
        runs = {
            'rans_encode_all': dict(
                kernel=enc_kernel, plain=enc_plain, plain_ms=enc_plain_ms,
                match=enc_match, extras=lambda: encode_oracle_times(
                    torch, enc_kernel, lambda: re_.rans_encode_all_rowsync(
                        inband, idx_t, row_n_t, cdfs, num_lanes=N),
                    inband[None], idx_t[None], row_n_t, cdfs, T),
                err=enc_err, launches=1, rows=T,
                # the pairs the kernel writes (the wrapper zero-fills the
                # buffer), the states and n_words
                bytes=4 * (2 * T * N + T) + table_bytes
                + 4 * ((n_words + 1) // 2) + 4 * (N + 1),
                # compare, shift, divide, remainder, shift, 2 adds
                ops=7 * nsym),
            'rans_decode_block': dict(
                kernel=dec_kernel, plain=dec_plain, plain_ms=dec_plain_ms,
                match=dec_match,
                err=dec_err, launches=len(blocks),
                rows=sum(int(rows.shape[0]) for rows, _ in blocks),
                bytes=4 * (2 * T * N + n_words + 2 * N + 2) + table_bytes,
                # a search over <= 256 entries (8 compares), state update,
                # renorm test and feed
                ops=16 * nsym)}
        for name, r in runs.items():
            times = cuda_times(torch, r['kernel'], KERNEL_REPEATS)
            ms = times[len(times) // 2]
            cold_ms = cold_l2_ms(torch, r['kernel'], KERNEL_REPEATS)
            plain_ms = cuda_ms(torch, r['plain'], PLAIN_REPEATS,
                               first_ms=r['plain_ms'])
            bytes_ms = r['bytes'] / HBM_BYTES_PER_S * 1e3
            ops_ms = r['ops'] / SCALAR_OPS_PER_S * 1e3
            results[name][N] = dict(
                T=T, nsym=nsym, n_words=n_words, escapes=n_esc,
                match=r['match'], max_abs_err=r['err'],
                launches_per_image=r['launches'], ms=ms,
                ms_cold_l2=cold_ms, rows=r['rows'],
                ns_per_row=ms * 1e6 / r['rows'],
                # the fastest and slowest of the warm timings
                ns_per_row_range=[t * 1e6 / r['rows']
                                  for t in (times[0], times[-1])],
                ns_per_row_cold_l2=cold_ms * 1e6 / r['rows'],
                plain_ms=plain_ms,
                bytes=r['bytes'], ops=r['ops'],
                bound_ms=max(bytes_ms, ops_ms),
                bound_by='bytes' if bytes_ms >= ops_ms else 'operations',
                **(r['extras']() if 'extras' in r else {}))
            progress(f'{name} N={N}: {ms:.3f} ms ({ms * 1e6 / r["rows"]:.0f} '
                     f'ns a row, cold L2 {cold_ms:.3f}), plain '
                     f'{plain_ms:.1f} ms{oracle_note(results[name][N])}')
    return results


def encode_oracle_times(torch, kernel, rowsync, syms, idx, row_n, cdfs,
                        rows):
    """The encode's extras at one shape (syms, idx (B, T, N) on the card):
    whether the row-sync kernel writes the kernel's bytes, its time
    (rowsync_ms), the chain phase's own time (chain_ms) and the chain's
    bound, its rows on parameters held in registers (chain_bound_ms), the
    last two also a row."""
    from lvae_tpu_torch.ops import rans_encode as re_
    same = all(torch.equal(a, b) for a, b in zip(kernel(), rowsync()))
    require(same, f'the encode disagrees with its row-sync kernel at '
                  f'{tuple(syms.shape)}')
    out = dict(rowsync_match=same,
               rowsync_ms=cuda_ms(torch, rowsync, KERNEL_REPEATS))
    for key, registers_only in (('chain', False), ('chain_bound', True)):
        ms = cuda_ms(torch, re_.chain_phase(syms, idx, row_n, cdfs,
                                            registers_only), KERNEL_REPEATS)
        out.update({f'{key}_ms': ms, f'{key}_ns_per_row': ms * 1e6 / rows})
    return out


def encode_oracle_keys(r):
    """encode_oracle_times' times for the kernels line ({} elsewhere)."""
    return {k: r[k] for k in ('rowsync_ms', 'chain_ms', 'chain_bound_ms')
            if k in r}


def oracle_note(r):
    """encode_oracle_times' numbers for a progress line ('' elsewhere)."""
    return (f', row-sync {r["rowsync_ms"]:.3f} ms, chain '
            f'{r["chain_ns_per_row"]:.1f} ns a row (bound '
            f'{r["chain_bound_ns_per_row"]:.1f})' if 'rowsync_ms' in r else '')


def check_multi_kernels(torch, np, table, device, lane_counts, batches):
    """Both multi-image kernels against their plain versions and against B
    single-kernel launches, at each lane count and batch size: B images of
    qarv_base size with one block layout (random_blocks' sizes depend on N
    only) and their own symbols; times of one multi launch (encode) or the
    nine of a batch (decode), of the B (9 B) single launches doing the same
    work, and of the plain version (its compared run)."""
    from lvae_tpu_torch.ops import rans_decode as rd, rans_encode as re_
    cdfs_np, offs_np = rd.prepare_device_cdf(table)
    cdfs = torch.as_tensor(cdfs_np, device=device)
    offs = torch.as_tensor(offs_np, device=device)
    lengths = torch.as_tensor(table.cdf_lengths, device=device)
    table_bytes = 4 * (cdfs.numel() + offs.numel())
    results = {'rans_encode_all_multi': {}, 'rans_decode_block_multi': {}}
    for N in lane_counts:
        for B in batches:
            per = [random_blocks(np, 1234 + N + 1000 * b, N,
                                 table.scale_table) for b in range(B)]
            rows = [re_.blocks_to_rows(v, i, N) for v, i in per]
            row_n = torch.as_tensor(rows[0][2], device=device)
            syms = torch.as_tensor(np.stack([r[0] for r in rows]),
                                   device=device)
            idx = torch.as_tensor(np.stack([r[1] for r in rows]),
                                  device=device)
            inband, _ = re_.prepare_inband(syms, idx, offs, lengths)
            T = syms.shape[1]
            sizes = [v.size for v in per[0][0]]
            nsym = sum(sizes)

            # ---- encode
            def enc_multi():
                return re_.rans_encode_all_multi(inband, idx, row_n, cdfs,
                                                 num_lanes=N)

            def enc_singles():
                return [re_.rans_encode_all(inband[b], idx[b], row_n, cdfs,
                                            num_lanes=N) for b in range(B)]

            got = enc_multi()
            alone = enc_singles()
            want, enc_plain_ms = timed(torch, lambda: (
                re_.rans_encode_all_multi_plain(inband, idx, row_n, cdfs)))
            enc_err = max(int((a.long() - b.long()).abs().max())
                          for a, b in zip(got, want))
            enc_plain = all(torch.equal(a, b) for a, b in zip(got, want))
            enc_single = all(
                torch.equal(got[0][b], p) and torch.equal(got[1][b], n)
                and torch.equal(got[2][b], st[0])
                for b, (p, n, st) in enumerate(alone))
            pairs, n_words, states = got
            n_words = n_words.tolist()

            # ---- decode the streams the multi encode wrote
            streams = np.zeros((B, max(n_words)), np.int32)
            host = pairs.cpu().numpy()
            for b, n in enumerate(n_words):
                streams[b, :n] = re_.pairs_to_words(host[b], n)[::-1]
            streams = torch.as_tensor(streams, device=device)
            blocks, r0 = [], 0
            for size in sizes:
                Tb = -(-size // N)
                blocks.append((idx[:, r0:r0 + Tb].contiguous(), size))
                r0 += Tb

            def dec_run(fn, keep=True):
                """As check_kernels' dec_run, for B images."""
                st = states
                p = torch.zeros(B, dtype=torch.int32, device=device)
                outs = []
                for rows_b, n in blocks:
                    v, st, p = fn(rows_b, st, p, streams, cdfs, offs, n)
                    if keep:
                        outs.append(v)
                return (torch.cat(outs, 1) if keep else None), st, p

            def dec_multi(keep=False):
                return dec_run(lambda *a: rd.rans_decode_block_multi(
                    *a, num_lanes=N), keep)

            def dec_singles(keep=False):
                outs = []
                for b in range(B):
                    st = states[b:b + 1]
                    p = torch.zeros((), dtype=torch.int32, device=device)
                    vals = []
                    for rows_b, n in blocks:
                        v, st, p = rd.rans_decode_block(
                            rows_b[b], st, p, streams[b], cdfs, offs, n,
                            num_lanes=N)
                        if keep:
                            vals.append(v)
                    outs.append((torch.cat(vals) if keep else None, st, p))
                return outs

            got = dec_multi(keep=True)
            alone = dec_singles(keep=True)
            want, dec_plain_ms = timed(torch, lambda: dec_run(
                rd.rans_decode_block_multi_plain))
            dec_err = max(int((a.long() - b.long()).abs().max())
                          for a, b in zip(got, want))
            dec_plain = all(torch.equal(a, b) for a, b in zip(got, want))
            dec_single = all(
                torch.equal(got[0][b], v) and torch.equal(got[1][b], st[0])
                and int(got[2][b]) == int(p)
                for b, (v, st, p) in enumerate(alone))
            active = (torch.arange(N, device=device)[None, :]
                      < row_n[:, None].long())
            roundtrip = (torch.equal(got[0], torch.where(
                active, inband + offs[idx], 0))
                and got[2].tolist() == n_words)
            what = f'N={N} B={B}'
            progress(f'multi {what}: T={T} encode plain={enc_plain} '
                     f'single={enc_single}; decode plain={dec_plain} '
                     f'single={dec_single} roundtrip={roundtrip}')
            require(enc_plain and enc_single,
                    f'rans_encode_all_multi {what} disagrees with its plain '
                    f'version or single launches (max abs err {enc_err})')
            require(dec_plain and dec_single and roundtrip,
                    f'rans_decode_block_multi {what} disagrees with its '
                    f'plain version or single launches (max abs err '
                    f'{dec_err}) or does not give back the symbols')
            runs = {
                'rans_encode_all_multi': dict(
                    multi=enc_multi, singles=enc_singles,
                    extras=lambda: encode_oracle_times(
                        torch, enc_multi,
                        lambda: re_.rans_encode_all_multi_rowsync(
                            inband, idx, row_n, cdfs, num_lanes=N),
                        inband, idx, row_n, cdfs, T),
                    plain_ms=enc_plain_ms, err=enc_err, launches=1, rows=T,
                    # the pairs the kernel writes (the wrapper zero-fills
                    # the buffer), the states and n_words
                    bytes=4 * (B * (2 * T * N + N + 1) + T + sum(
                        (n + 1) // 2 for n in n_words)) + table_bytes,
                    ops=B * 7 * nsym),
                'rans_decode_block_multi': dict(
                    multi=dec_multi, singles=dec_singles,
                    plain_ms=dec_plain_ms, err=dec_err, launches=len(blocks),
                    rows=sum(int(rows_b.shape[1]) for rows_b, _ in blocks),
                    bytes=4 * (B * (2 * T * N + 2 * N + 2) + sum(n_words))
                    + table_bytes,
                    ops=B * 16 * nsym)}
            for name, r in runs.items():
                ms = cuda_ms(torch, r['multi'], KERNEL_REPEATS)
                cold_ms = cold_l2_ms(torch, r['multi'], KERNEL_REPEATS)
                singles_ms = cuda_ms(torch, r['singles'], KERNEL_REPEATS)
                bytes_ms = r['bytes'] / HBM_BYTES_PER_S * 1e3
                ops_ms = r['ops'] / SCALAR_OPS_PER_S * 1e3
                results[name][f'N{N}_B{B}'] = dict(
                    N=N, B=B, T=T, nsym_per_image=nsym, n_words=n_words,
                    match_plain=True, match_single_launches=True,
                    max_abs_err=r['err'], launches_per_batch=r['launches'],
                    ms=ms, ms_cold_l2=cold_ms, rows=r['rows'],
                    ns_per_row=ms * 1e6 / r['rows'],
                    ns_per_row_cold_l2=cold_ms * 1e6 / r['rows'],
                    single_launches_ms=singles_ms,
                    plain_ms=r['plain_ms'], bytes=r['bytes'], ops=r['ops'],
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by='bytes' if bytes_ms >= ops_ms else 'operations',
                    **(r['extras']() if 'extras' in r else {}))
                progress(f'{name} {what}: {ms:.3f} ms, {B} images alone '
                         f'{singles_ms:.3f} ms, plain {r["plain_ms"]:.1f} ms'
                         f'{oracle_note(results[name][f"N{N}_B{B}"])}')
    return results


def decode_corner_case(torch, case, cdfs, offs, N):
    """One rans_corner_cases case (numpy) on the card: each image through
    rans_decode_block against rans_decode_block_plain, and both through
    rans_decode_block_multi against its plain version and against the two
    single launches, byte for byte (values, states, pointers). cdfs, offs:
    the table on the card. -> (single match, multi match, words each image
    took)."""
    from lvae_tpu_torch.ops import rans_decode as rd
    t = {k: torch.as_tensor(v, device=cdfs.device)
         for k, v in case.items() if k != 'nsym'}
    nsym = case['nsym']

    def same(got, want):
        return all(torch.equal(g, w) for g, w in zip(got, want))

    single, alone = True, []
    for b in range(2):
        args = (t['indexes'][b], t['states'][b:b + 1], t['ptrs'][b],
                t['streams'][b], cdfs, offs)
        got = rd.rans_decode_block(*args, nsym, num_lanes=N)
        single &= same(got, rd.rans_decode_block_plain(*args, nsym))
        alone.append(got)
    args = (t['indexes'], t['states'], t['ptrs'], t['streams'], cdfs, offs)
    got = rd.rans_decode_block_multi(*args, nsym, num_lanes=N)
    want = rd.rans_decode_block_multi_plain(*args, nsym)
    multi = same(got, want) and all(
        torch.equal(got[0][b], v) and torch.equal(got[1][b], st[0])
        and torch.equal(got[2][b], p) for b, (v, st, p) in enumerate(alone))
    return single, multi, (want[2].long() - t['ptrs'].long()).tolist()


def check_decode_corners(torch, device, tables):
    """decode_corner_case on every rans_corner_cases case, for each table
    of `tables` ({label: CdfTable}) at every lane count of CORNER_LANES.
    -> a row per case."""
    from lvae_tpu_torch.ops import rans_decode as rd
    rows = []
    for label, table in tables.items():
        cdfs_np, offs_np = rd.prepare_device_cdf(table)
        cdfs = torch.as_tensor(cdfs_np, device=device)
        offs = torch.as_tensor(offs_np, device=device)
        for N in CORNER_LANES:
            for name, c in rans_corner_cases(np, cdfs_np, offs_np, N):
                single, multi, words = decode_corner_case(torch, c, cdfs,
                                                          offs, N)
                rows.append(dict(
                    table=label, S=len(cdfs_np), N=N, case=name,
                    T=c['indexes'].shape[1], W=c['streams'].shape[1],
                    nsym=c['nsym'], words=words, single_match=single,
                    multi_match=multi))
                require(single and multi,
                        f'rANS decode corner case {name} (table {label}, '
                        f'N={N}): the kernel disagrees with its plain '
                        f'version or single launches')
    progress(f'rANS decode corner cases: {len(rows)} cases, all byte-equal')
    return rows


# the encode's corner cases (rans_encode_corner_cases): lane counts (one
# warp, ragged last warps, whole warps), batch sizes, rows of a case, and
# the rows of the N = 1 case whose scan crosses many tiles
ENCODE_CORNER_LANES = (1, 16, 31, 32, 33, 48, 64, 100, 128)
ENCODE_CORNER_BATCHES = (1, 2, 3, 6)
ENCODE_CORNER_ROWS, ENCODE_LONG_ROWS = 96, 60007
ENCODE_CORNER_TABLES = ('latent', 'head')


def encode_row_words(np, cdfs, syms, indexes, row_n):
    """The words each row of one image takes, rows T-1 .. 0: the plain
    encode's row loop in numpy (int64) on a sentinel-padded table."""
    T, N = syms.shape
    S, L = cdfs.shape
    c = cdfs.astype(np.int64)
    ix = np.clip(indexes, 0, S - 1)
    sy = np.clip(syms, 0, L - 2)
    start, freq = c[ix, sy], c[ix, sy + 1] - c[ix, sy]
    x = np.full(N, 1 << 16, np.int64)
    counts = []
    for t in range(T - 1, -1, -1):
        act = np.arange(N) < row_n[t]
        f = np.where(act, freq[t], 1)
        flag = act & ((x >> 16) >= f)
        counts.append(int(flag.sum()))
        x = np.where(flag, x >> 16, x)
        x = np.where(act, ((x // f) << 16) + x % f + np.where(act, start[t], 0),
                     x)
    return counts


def rans_encode_corner_cases(np, cdfs, N, rows=ENCODE_CORNER_ROWS,
                             long_rows=ENCODE_LONG_ROWS, seed=0):
    """Encode inputs at the encode's corners, for a sentinel-padded table
    (cdfs (S, L): prepare_device_cdf) and N lanes: [(name, case)], each case
    max(ENCODE_CORNER_BATCHES) images of one row layout: numpy int32 syms
    and indexes (B, T, N), row_n (T,), and w_cap. Image 0 is the corner
    (checked here with encode_row_words), the others further draws of the
    same kind. Every clamped (index, symbol) lies inside its CDF row, so the
    plain versions code every case too. T = `rows` but where named.
    - every_lane_renormalises: symbols of frequency 1, so every lane
      renormalises on every row;
    - no_lane_renormalises: the central symbol of the scale whose largest
      frequency is the table's largest (the narrowest): no lane
      renormalises;
    - empty_and_tail_rows: row lengths 0, N and between;
    - one_row: T = 1;
    - out_of_range: indexes below 0 and past S - 1, symbols below 0 and, on
      the widest scale (whose rows hold every bin), past L - 2: clamped;
    - w_cap_inside_row, w_cap_one, w_cap_all: the word capacity cut inside
      a row (N = 1: at half the words), 1, and T * N;
    - long_scan (N = 1 only): T = `long_rows`, a scan over many tiles.
    The other cases draw their symbols from the CDFs, one in ten uniform
    over the row's bins."""
    rng = np.random.default_rng(seed + 1000 * N + len(cdfs))
    S, L = cdfs.shape
    B = max(ENCODE_CORNER_BATCHES)
    c = cdfs.astype(np.int64)
    lengths = (cdfs <= 1 << 16).sum(1)           # the rest is the sentinel
    freq = np.diff(c, axis=1)
    valid = np.arange(L - 1)[None] < (lengths - 1)[:, None]
    ones = np.argwhere(valid & (freq == 1))
    central = np.unravel_index(np.argmax(np.where(valid, freq, 0)),
                               freq.shape)
    require(lengths[-1] == L, 'the widest scale is the last')

    # the rows laid end to end, row i lifted by i << 18 (entries <= 2^17):
    # one sorted array, searched for every (index, slot) at once
    flat = (c + (np.arange(S)[:, None] << 18)).ravel()

    def draw(T):
        ix = rng.integers(0, S, (B, T, N))
        slot = rng.integers(0, 1 << 16, (B, T, N))
        sy = np.searchsorted(flat, (ix << 18) + slot, 'right') - 1 - ix * L
        uniform = rng.random(ix.shape) < 0.1
        sy[uniform] = (rng.random(int(uniform.sum()))
                       * (lengths[ix[uniform]] - 1)).astype(np.int64)
        return sy, ix

    def case(sy, ix, row_n=None, w_cap=None):
        T = sy.shape[1]
        row_n = np.full(T, N) if row_n is None else row_n
        return dict(syms=sy.astype(np.int32), indexes=ix.astype(np.int32),
                    row_n=np.asarray(row_n, np.int32),
                    w_cap=T * N if w_cap is None else int(w_cap))

    T = rows
    pick = ones[rng.integers(0, len(ones), (B, T, N))]
    cases = [('every_lane_renormalises', case(pick[..., 1], pick[..., 0])),
             ('no_lane_renormalises',
              case(np.full((B, T, N), central[1]),
                   np.full((B, T, N), central[0])))]
    sy, ix = draw(T)
    row_n = rng.integers(0, N + 1, T)
    row_n[::3], row_n[1::3] = 0, N
    cases.append(('empty_and_tail_rows', case(sy, ix, row_n)))
    cases.append(('one_row', case(*draw(1))))
    sy, ix = draw(T)
    kind = rng.integers(0, 5, (B, T, N))
    kind.reshape(B, -1)[:, :5] = np.arange(5)     # every kind in each image
    ix = np.where(kind == 1, rng.integers(-5, 0, ix.shape), ix)
    sy = np.where(kind == 1, np.minimum(sy, lengths[0] - 2), sy)
    hi = S + rng.integers(0, 5, ix.shape)        # the widest scale, clamped
    ix = np.where(kind == 2, hi, ix)
    sy = np.where(kind == 3, rng.integers(-5, 0, sy.shape), sy)
    ix = np.where(kind == 4, hi, ix)
    sy = np.where(kind == 4, rng.integers(L - 1, L + 5, sy.shape), sy)
    cases.append(('out_of_range', case(sy, ix)))
    sy, ix = draw(T)
    counts = encode_row_words(np, cdfs, sy[0], ix[0], np.full(T, N))
    ends = np.cumsum([0] + counts)
    if N > 1:
        k = next(k for k, n in enumerate(counts) if n >= 2)
        cut = int(ends[k]) + counts[k] // 2
    else:
        cut = int(ends[-1]) // 2
    cases += [('w_cap_inside_row', case(sy, ix, w_cap=cut)),
              ('w_cap_one', case(sy, ix, w_cap=1)),
              ('w_cap_all', case(sy, ix))]
    if N == 1:
        cases.append(('long_scan', case(*draw(long_rows))))
    for name, cs in cases:
        counts = encode_row_words(np, cdfs, cs['syms'][0], cs['indexes'][0],
                                  cs['row_n'])
        ends = np.cumsum([0] + counts)
        rn = cs['row_n'][::-1]
        ok = {'every_lane_renormalises': counts == rn.tolist(),
              'no_lane_renormalises': ends[-1] == 0,
              'empty_and_tail_rows': (rn == 0).any() and (rn == N).any()
              and (N == 1 or ((rn > 0) & (rn < N)).any()),
              'one_row': len(counts) == 1,
              'out_of_range': ((cs['indexes'] < 0).any()
                               and (cs['indexes'] >= S).any()
                               and (cs['syms'] < 0).any()
                               and (cs['syms'] > L - 2).any()),
              'w_cap_inside_row': ends[-1] > cs['w_cap'] and (
                  N == 1 or not np.isin(cs['w_cap'], ends)),
              'w_cap_one': ends[-1] > 1,
              'w_cap_all': cs['w_cap'] == len(counts) * N,
              'long_scan': len(counts) == long_rows}[name]
        if not ok:
            raise AssertionError(f'rans_encode_corner_cases N={N} S={S}: '
                                 f'{name} misses its corner')
    return cases


def encode_corner_case(torch, case, cdfs, N):
    """One rans_encode_corner_cases case on the card: each image through
    rans_encode_all against the row-sync kernel, the first B images (each B
    of ENCODE_CORNER_BATCHES) through rans_encode_all_multi against its
    row-sync kernel and the B single launches, and the plain versions on
    image 0 and on all images; byte for byte (pairs, n_words, states).
    cdfs: the table on the card. -> (single, multi, plain) matches."""
    from lvae_tpu_torch.ops import rans_encode as re_
    t = {k: torch.as_tensor(case[k], device=cdfs.device)
         for k in ('syms', 'indexes', 'row_n')}
    kw = dict(num_lanes=N, w_cap=case['w_cap'])

    def same(got, want):
        return all(torch.equal(g, w) for g, w in zip(got, want))

    single, alone = True, []
    for b in range(len(case['syms'])):
        args = (t['syms'][b], t['indexes'][b], t['row_n'], cdfs)
        got = re_.rans_encode_all(*args, **kw)
        single &= same(got, re_.rans_encode_all_rowsync(*args, **kw))
        alone.append(got)
    plain = same(alone[0], re_.rans_encode_all_plain(
        t['syms'][0], t['indexes'][0], t['row_n'], cdfs, case['w_cap']))
    multi = True
    for B in ENCODE_CORNER_BATCHES:
        args = (t['syms'][:B], t['indexes'][:B], t['row_n'], cdfs)
        got = re_.rans_encode_all_multi(*args, **kw)
        multi &= same(got, re_.rans_encode_all_multi_rowsync(*args, **kw))
        multi &= all(torch.equal(got[0][b], p) and torch.equal(got[1][b], n)
                     and torch.equal(got[2][b], st[0])
                     for b, (p, n, st) in enumerate(alone[:B]))
    plain &= same(got, re_.rans_encode_all_multi_plain(*args[:3], cdfs,
                                                       case['w_cap']))
    return single, multi, plain


def rans_encode_checks(torch, device):
    """encode_corner_case on every rans_encode_corner_cases case of each
    table of ENCODE_CORNER_TABLES at every lane count of
    ENCODE_CORNER_LANES. -> a row per case."""
    from lvae_tpu_torch.ops import rans_decode as rd
    from lvae_tpu_torch.ops import cdf
    tables = corner_scale_tables()
    rows = []
    for label in ENCODE_CORNER_TABLES:
        cdfs_np, _ = rd.prepare_device_cdf(cdf.build_cdf_table(tables[label]))
        cdfs = torch.as_tensor(cdfs_np, device=device)
        for N in ENCODE_CORNER_LANES:
            for name, c in rans_encode_corner_cases(np, cdfs_np, N):
                single, multi, plain = encode_corner_case(torch, c, cdfs, N)
                rows.append(dict(
                    table=label, N=N, case=name, T=len(c['row_n']),
                    w_cap=c['w_cap'], batches=list(ENCODE_CORNER_BATCHES),
                    single_match=single, multi_match=multi,
                    plain_match=plain))
                require(single and multi and plain,
                        f'rANS encode corner case {name} (table {label}, '
                        f'N={N}): the kernel disagrees with the row-sync '
                        f'kernel, B single launches or its plain version')
    progress(f'rANS encode corner cases: {len(rows)} cases, all byte-equal')
    return rows


def launch_counters():
    """{kernel name: wrapper} for every kernel of the main paths."""
    from lvae_tpu_torch.ops import rans_decode as rd, rans_encode as re_
    from lvae_tpu_torch.ops import trunk
    counted = {'rans_encode_all': re_.rans_encode_all,
               'rans_decode_block': rd.rans_decode_block,
               'rans_encode_all_multi': re_.rans_encode_all_multi,
               'rans_decode_block_multi': rd.rans_decode_block_multi}
    counted.update((k.__name__, k) for k in trunk.KERNELS)
    return counted


def counted_call(fn):
    """(fn(), {kernel: launches in that call}): every count set to 0 just
    before the call and read just after it."""
    counters = launch_counters()
    for k in counters.values():
        k.launches = 0
    out = fn()
    return out, {n: k.launches for n, k in counters.items()}


def psnr_bpp(rec, im, n_bytes):
    mse = float(np.mean((rec - im) ** 2))
    return -10 * math.log10(mse + 1e-12), n_bytes * 8 / (im.shape[1]
                                                          * im.shape[2])


def with_rowsync_encode(fn):
    """fn() with the row-sync encode kernel in place of the encode (both
    entry points), for that one call."""
    from lvae_tpu_torch.ops import rans_encode as re_
    saved = re_.rans_encode_all, re_.rans_encode_all_multi
    re_.rans_encode_all = re_.rans_encode_all_rowsync
    re_.rans_encode_all_multi = re_.rans_encode_all_multi_rowsync
    try:
        return fn()
    finally:
        re_.rans_encode_all, re_.rans_encode_all_multi = saved


def run_codec(torch, model, portable, cases, tmpdir):
    """compress_file -> decompress_file of each (image, lambda), on one
    trunk, each call's kernel launches counted; the round trip checked
    bitwise against compress_check, rate and quality against the JAX
    package's results, the launches against the expected per-image counts;
    then enc_ms / dec_ms (one warm-up, median of 3)."""
    from lvae_tpu_torch.utils import coding
    kind = 'portable' if portable else 'legacy'
    rows = []
    for image, lmb in cases:
        img = coding.read_png(image)
        H, W = img.shape[:2]
        im = img.astype(np.float32)[None] / 255.0
        path = os.path.join(tmpdir, f'{os.path.basename(image)}.{kind}.'
                                    f'lmb{lmb:g}.bits')
        _, enc_launches = counted_call(lambda: model.compress_file(
            image, path, lmb=lmb, portable=portable))
        rec, dec_launches = counted_call(lambda: model.decompress_file(path))
        with open(path, 'rb') as f:
            body = f.read()[4:]
        rowsync_path = path + '.rowsync'
        with_rowsync_encode(lambda: model.compress_file(
            image, rowsync_path, lmb=lmb, portable=portable))
        with open(rowsync_path, 'rb') as f:
            rowsync_same = f.read()[4:] == body
        lanes_field = struct.unpack('<H', body[18:20])[0]
        psnr, bpp = psnr_bpp(rec, im, len(body))
        # the port's own round-trip check: the encode side's
        # reconstruction of the same latents equals the decode, bitwise
        body_chk, rec_chk = model.compress_check(im, lmb=lmb,
                                                 portable=portable)
        bit_exact = bool(body_chk == body
                         and np.array_equal(rec_chk[:, :H, :W], rec))
        model.decompress(model.compress(im, lmb=lmb, portable=portable))
        enc_ms = cuda_ms(torch, lambda: model.compress(
            im, lmb=lmb, portable=portable), 3)
        dec_ms = cuda_ms(torch, lambda: model.decompress(body), 3)
        rans = rans_share(torch, lambda: model.decompress(body), dec_ms)
        row = dict(trunk=kind, image=os.path.relpath(image, ROOT), lmb=lmb,
                   lanes=lanes_field & 0x7FFF,
                   portable_marker=bool(lanes_field & 0x8000),
                   bytes=len(body), bpp=bpp, psnr=psnr,
                   finite=bool(np.isfinite(rec).all()),
                   shape=list(rec.shape), shape_ok=rec.shape == (1, H, W, 3),
                   bit_exact=bit_exact, rowsync_file_equal=rowsync_same,
                   enc_ms=enc_ms, dec_ms=dec_ms, **rans,
                   encode_launches=enc_launches,
                   decode_launches=dec_launches, path=path)
        ref = REFERENCE.get((image, lmb)) or REPORTED.get((image, lmb))
        if ref:
            row.update(ref_bpp=ref[0], ref_psnr=ref[1],
                       bpp_rel_diff=bpp / ref[0] - 1,
                       psnr_diff_db=psnr - ref[1],
                       gated=(image, lmb) in REFERENCE)
        rows.append(row)
        progress(f'{kind} {os.path.basename(image)} lambda={lmb:g}: '
                 f'N={row["lanes"]} {bpp:.4f} bpp {psnr:.2f} dB '
                 f'bit_exact={bit_exact} enc {enc_ms:.1f} ms '
                 f'dec {dec_ms:.1f} ms')

    want_enc, want_dec = EXPECTED_LAUNCHES[portable]
    for row in rows:
        what = f'{kind} {row["image"]} lambda {row["lmb"]:g}'
        require(row['bit_exact'], f'{what}: decode is not bit-exact')
        require(row['rowsync_file_equal'],
                f'{what}: the file differs with the row-sync encode kernel')
        require(row['portable_marker'] == portable,
                f'{what}: wrong trunk-kind marker')
        require(row['finite'] and row['shape_ok'],
                f'{what}: bad reconstruction')
        require(row['encode_launches'] == want_enc
                and row['decode_launches'] == want_dec,
                f'{what}: unexpected kernel launches '
                f'{row["encode_launches"]} / {row["decode_launches"]}')
        if row.get('gated'):
            require(abs(row['bpp_rel_diff']) <= BPP_REL_TOL,
                    f'{what}: bpp {row["bpp"]:.4f} vs {row["ref_bpp"]}')
            require(abs(row['psnr_diff_db']) <= PSNR_TOL_DB,
                    f'{what}: PSNR {row["psnr"]:.2f} vs {row["ref_psnr"]}')
    return rows


# ---- batch serving -----------------------------------------------------------

def _host_ms(torch, fn, repeats=3):
    """Median host-clock time (ms) of fn() ending in a device
    synchronisation, after one warm-up call; -> (ms, last result)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[len(times) // 2], out


def run_batch(torch, model, tmpdir):
    """The batch main path on the portable trunk, with its checks (see the
    module docstring, 6). -> (result dict, {kernel: launches} of the B = 6
    request's compress_batch + decompress_batch, fresh-process case)."""
    from lvae_tpu_torch.utils import coding
    with open(SWEEP) as f:
        sweep = json.load(f)
    photos = [coding.read_png(p) for p in PHOTOS]
    u8 = np.stack(photos + photos)                       # photo1..3 twice
    ims = u8.astype(np.float32) / 255.0
    lmbs = [BATCH_LAMBDAS[0]] * 3 + [BATCH_LAMBDAS[1]] * 3
    H, W = u8.shape[1:3]
    model.compress_mode(num_lanes='auto', portable=True)

    # 1. round trip, rate and quality; the launches of each call
    bodies, enc_l = counted_call(lambda: model.compress_batch(ims, lmb=lmbs))
    dec, dec_l = counted_call(lambda: model.decompress_batch(bodies))
    rowsync_same = with_rowsync_encode(
        lambda: model.compress_batch(ims, lmb=lmbs)) == bodies
    codec = model._fused
    lmb_t = torch.tensor([struct.unpack('f', struct.pack('f', v))[0]
                          for v in lmbs], device=model.device)
    ims_t = torch.as_tensor(ims, device=model.device).permute(0, 3, 1, 2)
    bodies_chk, recon = codec.encode_check_batch(ims_t.contiguous(), lmb_t)
    bit_exact = bool([b[10:] for b in bodies] == bodies_chk
                     and np.array_equal(dec, recon))
    fields = sorted({struct.unpack('<H', b[18:20])[0] for b in bodies})
    per_lmb = []
    for i, lmb in enumerate(BATCH_LAMBDAS):
        rows = range(3 * i, 3 * i + 3)
        bpp = float(np.mean([(len(bodies[r]) + 4) * 8 / (H * W)
                             for r in rows]))
        psnr = float(np.mean([-10 * math.log10(max(float(np.mean(
            (dec[r] - ims[r]) ** 2)), 1e-12)) for r in rows]))
        k = sweep['lambdas'].index(lmb)
        ref_bpp, ref_psnr = (sweep['results']['bpp'][k],
                             sweep['results']['psnr'][k])
        per_lmb.append(dict(lmb=lmb, bpp=bpp, psnr=psnr, ref_bpp=ref_bpp,
                            ref_psnr=ref_psnr, bpp_rel_diff=bpp / ref_bpp - 1,
                            psnr_diff_db=psnr - ref_psnr))
        progress(f'batch lambda {lmb:g}: {bpp:.4f} bpp {psnr:.2f} dB '
                 f'(reference {ref_bpp:.4f} / {ref_psnr:.2f})')
    want_enc, want_dec = EXPECTED_BATCH_LAUNCHES

    # 2. across batch sizes: a batch stream alone, single streams as a batch
    alone0 = model.decompress(bodies[0])
    singles = [model.compress(ims[b:b + 1], lmb=BATCH_LAMBDAS[1])
               for b in range(3)]
    as_batch = model.decompress_batch(singles)
    singles_ok = bool(np.array_equal(as_batch, np.concatenate(
        [model.decompress(s) for s in singles])))
    fresh_path = os.path.join(tmpdir, 'batch_photo1_lmb2048.bits')
    with open(fresh_path, 'wb') as f:
        f.write(struct.pack('2H', H, W) + bodies[3])

    # 3. chunks: max_program_batch=4 splits B = 6 into [3, 3]
    model.compress_mode(num_lanes='auto', portable=True, max_program_batch=4)
    chunked, chunk_enc_l = counted_call(
        lambda: model.compress_batch(ims, lmb=lmbs))
    chunk_dec, chunk_dec_l = counted_call(
        lambda: model.decompress_batch(chunked))
    ccodec = model._fused
    cbodies, crecon = ccodec.encode_check_batch(ims_t.contiguous(), lmb_t)
    chunk_ok = bool([b[10:] for b in chunked] == cbodies
                    and np.array_equal(chunk_dec, crecon))
    split = ccodec._chunk_sizes(len(lmbs), ccodec.max_program_batch)
    trunk_shapes = check_trunk_batch_shapes(torch, model, ims, lmbs)

    # 4. dispatch without a host synchronisation, on a device-resident
    # batch, on both trunks (the portable one's bytes are step 1's)
    ims_dev = torch.as_tensor(ims, device=model.device)
    no_sync_same = {}
    for portable in (True, False):
        model.compress_mode(num_lanes='auto', portable=portable)
        want = model.compress_batch(ims_dev, lmb=lmbs)        # warm caches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error')
        try:
            handle = model.compress_batch_async(ims_dev, lmb=lmbs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        no_sync_same['portable' if portable else 'legacy'] = (
            model.compress_batch_finish(handle) == want
            and (not portable or want == bodies))

    model.compress_mode(num_lanes='auto', portable=True)

    result = dict(
        images=[os.path.relpath(p, ROOT) for p in PHOTOS] * 2, lmbs=lmbs,
        lane_fields=fields, bit_exact=bit_exact, per_lambda=per_lmb,
        rowsync_bodies_equal=rowsync_same,
        stream_bytes=[len(b) for b in bodies],
        batch_stream_alone_bitwise=bool(np.array_equal(alone0[0], dec[0])),
        single_streams_as_batch_bitwise=singles_ok,
        encode_launches=enc_l, decode_launches=dec_l,
        chunks=split, chunked_bit_exact=chunk_ok,
        trunk_kernels_at_batch_shapes=trunk_shapes,
        chunked_encode_launches=chunk_enc_l,
        chunked_decode_launches=chunk_dec_l,
        dispatch_without_host_sync=['portable', 'legacy'],
        dispatch_same_bytes=no_sync_same)
    progress(f'batch B=6: bit_exact={bit_exact} alone={result["batch_stream_alone_bitwise"]} '
             f'singles={singles_ok} chunks={split} chunked={chunk_ok} '
             f'no_sync_same={no_sync_same}')
    require(fields == [0x8000 | 128], f'batch lane fields {fields}')
    require(bit_exact, 'batch decode is not bit-exact')
    require(rowsync_same, 'the batch bodies differ with the row-sync encode '
                          'kernel')
    for r in per_lmb:
        require(abs(r['bpp_rel_diff']) <= BPP_REL_TOL
                and abs(r['psnr_diff_db']) <= PSNR_TOL_DB,
                f'batch lambda {r["lmb"]:g}: {r["bpp"]:.4f} bpp / '
                f'{r["psnr"]:.2f} dB vs {r["ref_bpp"]:.4f} / '
                f'{r["ref_psnr"]:.2f}')
    require(result['batch_stream_alone_bitwise'],
            'a batch stream decoded alone gives other pixels')
    require(singles_ok, 'single streams decoded as a batch give other pixels')
    require(split == [3, 3] and chunk_ok, f'chunked request {split}: not '
                                          f'bit-exact')
    require(all(no_sync_same.values()),
            f'the dispatch-checked batch gave other bytes: {no_sync_same}')
    for got, want, what in ((enc_l, want_enc, 'compress_batch'),
                            (dec_l, want_dec, 'decompress_batch')):
        require(got == want, f'{what}: launches {got}, expected {want}')
    for got, want, what in ((chunk_enc_l, want_enc, 'chunked compress'),
                            (chunk_dec_l, want_dec, 'chunked decompress')):
        require(got == {k: 2 * v for k, v in want.items()},
                f'{what}: launches {got}, expected twice {want}')
    launches = {n: enc_l[n] + dec_l[n] for n in enc_l}
    return result, launches, ('batch stream, photo1 lambda 2048', 'qarv',
                              fresh_path, dec[3:4])


# ---- the portable-trunk kernels --------------------------------------------

# per kernel: which arguments are per image (batched along dim 0), so that a
# batch of two can be built from a main-path input and a second image
PER_IMAGE_ARGS = {'emb_mlp': (0,), 'dw_ln_mod': (0, 5), 'mlp_res': (0, 6),
                  'dense': (0,), 'prior_head': (0,), 'fuse_zproj': (0, 1, 2),
                  'finish_image': (0,), 'dw_ln_affine': (0,),
                  'dense_act': (0,), 'conv_kxk_act': (0,),
                  'zadd_dense': (0, 1), 'zadd': (0, 1),
                  'zadd_conv_kxk': (0, 1),
                  'res_dense_act': (0, 1), 'nll_head': (0, 1),
                  'nll_recon': (0, 1), 'upsample_finish': (0,),
                  'upsample_head': (0,)}


def _signature(args):
    return tuple((tuple(a.shape), str(a.dtype)) if hasattr(a, 'shape')
                 else a for a in args)


def capture_trunk_inputs(encode, decode, names=QARV_TRUNK):
    """Run encode() and decode(encode()) with the trunk wrappers of `names`
    wrapped by a recorder: -> ({name: {signature: cloned args}}, {name:
    {signature: (encode calls, decode calls)}})."""
    from lvae_tpu_torch.ops import trunk
    inputs = {n: {} for n in names}
    calls = {n: {} for n in names}
    originals = {n: getattr(trunk, n) for n in names}
    phase = {'i': 0}

    def recorder(name, fn):
        def call(*args):
            sig = _signature(args)
            if sig not in inputs[name]:
                inputs[name][sig] = tuple(
                    a.detach().clone() if hasattr(a, 'clone') else a
                    for a in args)
            n = calls[name].setdefault(sig, [0, 0])
            n[phase['i']] += 1
            return fn(*args)
        # the wrappers count their launches through their module-level
        # name, which is the recorder while it is installed
        call.launches = 0
        return call

    for n, fn in originals.items():
        setattr(trunk, n, recorder(n, fn))
    try:
        out = encode()
        phase['i'] = 1
        decode(out)
    finally:
        for n, fn in originals.items():
            setattr(trunk, n, fn)
    return inputs, calls


def compare_trunk_kernel(torch, name, args, fn=None):
    """One trunk kernel (or `fn`, another design of the same function)
    against its plain version on `args`: -> (outputs, max abs err, largest
    err over the tolerance, index flips, whether every flip lies at a table
    entry)."""
    from lvae_tpu_torch.ops import trunk
    got = (fn or getattr(trunk, name))(*args)
    want = trunk.PLAIN[getattr(trunk, name)](*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err, worst, flips, flips_ok = 0.0, 0.0, 0, True
    ulp = HALF_ULP if name == 'upsample_finish' else 0.0
    for g, w in zip(got, want):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f'{name} {_signature(args)}: output {g.shape} {g.dtype} vs '
                f'{w.shape} {w.dtype}')
        if g.dtype == torch.int32:      # scale indexes
            flip = g != w
            flips = int(flip.sum())
            if flips:
                # a flip is allowed only where the plain scale lies within
                # the float tolerance of a table entry
                if name == 'nll_head':
                    _, pv, _ = trunk.nll_scales_plain(*args)
                    table = args[2]
                else:
                    _, pv, _ = trunk.prior_scales_plain(*args)
                    table = args[3]
                near = ((pv[flip][:, None] - table[None]).abs()
                        <= TRUNK_ATOL + TRUNK_RTOL * table[None])
                flips_ok = bool(near.any(1).all())
            continue
        d = (g.float() - w.float()).abs()
        err = max(err, float(d.max()))
        worst = max(worst, float(
            (d / (TRUNK_ATOL + TRUNK_RTOL * w.float().abs() + ulp)).max()))
    return got, err, worst, flips, flips_ok


def require_trunk_match(what, worst, flips_ok):
    require(worst <= 1.0, f'{what}: disagrees with its plain version')
    require(flips_ok, f'{what}: scale-index flip away from a table entry')


def require_bitwise(name, rows):
    """nll_head and nll_recon must equal their plain versions bitwise at
    every shape: pm, the scale indexes and the pixels."""
    for r in rows:
        require(r['max_abs_err'] == 0.0 and r['index_flips'] == 0,
                f'{name} at {r.get("shapes")}: not bitwise equal to its '
                f'plain version (max abs err {r["max_abs_err"]:.3g}, '
                f'{r["index_flips"]} index flips)')


def check_trunk_batch_shapes(torch, model, ims, lmbs):
    """Each trunk kernel against its plain version at the shapes the batch
    path gives it: inputs captured from compress_batch + decompress_batch
    of the request `ims` (lambdas `lmbs`) in one chunk and split by
    max_program_batch=4 (for B = 6: [3, 3]), every distinct shape; the
    tolerance and index-flip rule of check_trunk_kernels. Leaves the codec
    in its one-chunk mode. -> {kernel: summary}."""
    from lvae_tpu_torch.models.fused_base import FusedCodecBase
    torch.backends.cuda.matmul.allow_tf32 = False   # exact plain products
    inputs = {n: {} for n in QARV_TRUNK}
    want = sorted({len(lmbs), *FusedCodecBase._chunk_sizes(len(lmbs), 4)})
    for cap in (4, None):
        model.compress_mode(num_lanes='auto', portable=True,
                            max_program_batch=cap)
        more, _ = capture_trunk_inputs(
            lambda: model.compress_batch(ims, lmb=lmbs),
            model.decompress_batch)
        for name in QARV_TRUNK:
            for sig, args in more[name].items():
                inputs[name].setdefault(sig, args)
    out = {}
    for name in QARV_TRUNK:
        rows = []
        for sig, args in inputs[name].items():
            got, err, worst, flips, flips_ok = compare_trunk_kernel(
                torch, name, args)
            core_ok = (core_bitwise(torch, name, args, got)
                       if name in CORE_NAMES else None)
            warp_ok = (warp_bitwise(torch, name, args, got[0])
                       if name in DW_NAMES else None)
            oracle_ok = (oracle_bitwise(torch, name, args, got)
                         if name in REDESIGN_ORACLES else None)
            rows.append(dict(images=sig[0][0][0], max_abs_err=err,
                             err_over_tolerance=worst, index_flips=flips,
                             core_bitwise=core_ok, warp_bitwise=warp_ok,
                             oracle_bitwise=oracle_ok))
            require_trunk_match(f'{name} at batch shapes {sig} (max abs err '
                                f'{err:.3g})', worst, flips_ok)
            require(core_ok is not False, f'{name} at batch shapes {sig}: '
                                          f'not bitwise equal to the old '
                                          f'product core')
            require(warp_ok is not False, f'{name} at batch shapes {sig}: '
                                          f'not bitwise equal to the '
                                          f'warp-per-pixel kernel')
            require(oracle_ok is not False, f'{name} at batch shapes {sig}: '
                                            f'not bitwise equal to the '
                                            f'design it replaced')
        # every kernel runs on the whole chunk: its first argument leads
        # with the chunk's image count
        batches = sorted({r['images'] for r in rows})
        require(batches == want, f'{name} ran on batches of {batches}, '
                                 f'expected {want}')
        out[name] = dict(
            shapes_checked=len(rows),
            max_abs_err=max(r['max_abs_err'] for r in rows),
            err_over_tolerance=max(r['err_over_tolerance'] for r in rows),
            index_flips=sum(r['index_flips'] for r in rows),
            batch_sizes=batches)
        progress(f'{name} at batch shapes: {len(rows)} shapes, err '
                 f'{out[name]["max_abs_err"]:.2e} '
                 f'({out[name]["err_over_tolerance"]:.2f} of tol), flips '
                 f'{out[name]["index_flips"]}')
    return out


def second_image(torch, name, args):
    """The batch-of-two arguments: each per-image input beside a different
    one (the same values flipped along their last axes, or another
    lambda)."""
    out = list(args)
    for i in PER_IMAGE_ARGS[name]:
        a = args[i]
        other = (a * 0 + 512.0 if name == 'emb_mlp'
                 else torch.flip(a, dims=[a.ndim - 1, a.ndim - 2]))
        out[i] = torch.cat([a, other]).contiguous()
    return out


def work(name, args):
    """(bytes the function must move, operations it does) for one call:
    each input read once, each output written once."""
    def n(a):
        return a.numel()

    if name == 'emb_mlp':
        lmb, freqs, w0, b0, w1, b1, _ = args
        B, (E0, E) = n(lmb), w0.shape
        return (4 * (B + n(freqs) + n(w0) + n(b0) + n(w1) + n(b1) + 2 * B * E),
                2 * B * (E0 * E + E * E))
    if name == 'dw_ln_mod':
        x, dwk, dwb, ew, eb, gemb, K = args
        B, H, W, C = x.shape
        return (4 * (2 * n(x) + n(dwk) + n(dwb) + n(ew) + n(eb) + n(gemb)),
                n(x) * (2 * K * K + 8) + 2 * n(gemb) * 2 * C)
    if name == 'mlp_res':
        t, w1, b1, w2, b2, g, s = args
        M = t.shape[0] * t.shape[1]
        return (4 * (n(t) + 2 * n(s) + n(w1) + n(b1) + n(w2) + n(b2) + n(g)),
                2 * M * (n(w1) + n(w2)))
    if name == 'dense':
        x, w, b = args
        M = x.shape[0] * x.shape[1]
        return 4 * (n(x) + M * w.shape[1] + n(w) + n(b)), 2 * M * n(w)
    if name == 'prior_head':
        # the index of a scale in the ascending table needs ~log2(S)
        # compares (the kernel counts over all S: more than the bound)
        x, w, b, table = args[:4]
        M, Z = x.shape[0] * x.shape[1], w.shape[1] // 2
        return (4 * (n(x) + n(w) + n(b) + n(table) + 2 * M * Z),
                2 * M * n(w) + M * Z * math.ceil(math.log2(n(table))))
    if name == 'fuse_zproj':
        f, syms, pm, w, b = args
        M = f.shape[0] * f.shape[1]
        return (4 * (2 * n(f) + n(syms) + n(pm) + n(w) + n(b)),
                2 * M * n(w))
    if name == 'finish_image':
        x, = args
        return 4 * 2 * n(x), 4 * n(x)
    if name in ('upsample_finish', 'upsample_head'):
        # the product's operations (the finish's four an output and the
        # float16 rounding are not counted); the feature and the weights
        # read once, the outputs written once (2 bytes a float16)
        x, ws, bs = args[0], args[1:-1:2], args[2:-1:2]
        M = x.shape[0] * x.shape[1] * x.shape[2]
        out = (2 if name == 'upsample_finish' else 4) * M * sum(
            w.shape[1] for w in ws)
        return (4 * (n(x) + sum(n(w) + n(b) for w, b in zip(ws, bs))) + out,
                2 * M * sum(n(w) for w in ws))
    if name == 'dw_ln_affine':
        x, dwk, dwb, scale, bias, K = args
        return (4 * (2 * n(x) + n(dwk) + n(dwb) + n(scale) + n(bias)),
                n(x) * (2 * K * K + 8))
    if name == 'dense_act':
        x, w, b = args[:3]
        act = args[3] if len(args) > 3 else True
        M = x.shape[0] * x.shape[1]
        return (4 * (n(x) + M * w.shape[1] + n(w) + n(b)),
                2 * M * n(w) + GELU_OPS * n(x) * act)
    if name == 'conv_kxk_act':
        x, wk, b = args[:3]
        act = args[3] if len(args) > 3 else True
        M = x.shape[0] * x.shape[1] * x.shape[2]
        return (4 * (n(x) + M * wk.shape[-1] + n(wk) + n(b)),
                2 * M * n(wk) + GELU_OPS * n(x) * act)
    if name == 'zadd_dense':
        syms, pm, w, b = args
        M = syms.shape[0] * syms.shape[1]
        return (4 * (n(syms) + n(pm) + M * w.shape[1] + n(w) + n(b)),
                2 * M * n(w) + n(pm))
    if name == 'zadd':
        syms, pm = args
        return 4 * 3 * n(pm), n(pm)
    if name == 'zadd_conv_kxk':
        syms, pm, wk, b = args
        M = syms.shape[0] * syms.shape[1] * syms.shape[2]
        return (4 * (n(syms) + n(pm) + M * wk.shape[-1] + n(wk) + n(b)),
                2 * M * n(wk) + n(pm))
    if name == 'res_dense_act':
        f, t, w, b = args
        M = f.shape[0] * f.shape[1]
        return (4 * (2 * n(f) + n(t) + n(w) + n(b)),
                2 * M * n(w) + GELU_OPS * n(t) + 2 * n(f))
    if name == 'nll_head':
        # ~18 operations an element (softplus, the grid rounding, exp, the
        # clamp) and ~log2(S) compares for the index in the ascending table
        m, r, table = args[:3]
        return (4 * (4 * n(m) + n(table)),
                n(m) * (18 + math.ceil(math.log2(n(table)))))
    if name == 'nll_recon':
        syms, pm = args[:2]
        return 4 * 3 * n(pm), 8 * n(pm)
    raise KeyError(name)


LIBRARY_CALLS = {
    'dense': 'torch.addmm(b, x, w), TF32 off',
    'conv_kxk_act': 'F.conv2d (cuDNN, TF32 off) on launches without GELU, '
                    'of which the main path has none (z_proj_0 runs as '
                    'zadd_conv_kxk); none computes the GELU-first conv',
    'zadd': 'torch.add(syms, pm) (int32 + float32 promotes to float32)',
    'zadd_dense': 'torch.addmm(b, z, w), TF32 off, on z = syms.float() + pm '
                  'computed beforehand',
    'zadd_conv_kxk': 'F.conv2d (cuDNN, TF32 off) on z = syms.float() + pm '
                     'computed beforehand'}


# operations of one GELU (the A&S erf polynomial: |x|, the reciprocal, ten
# multiply-adds, the exponential's argument and the outer 0.5 * x * (1 + .))
GELU_OPS = 20


def library_call(torch, name, args):
    """One PyTorch call computing the same function on the same inputs,
    where there is one: torch.addmm for dense (and dense_act without its
    GELU), F.conv2d for conv_kxk_act without its GELU (NHWC views, weight
    in torch's layout prepared outside the call), the same on z =
    syms.float() + pm computed beforehand for zadd_conv_kxk, torch.add for
    zadd, torch.addmm on that z for zadd_dense; else None."""
    import torch.nn.functional as F
    if name == 'dense' or (name == 'dense_act' and len(args) > 3
                           and not args[3]):
        x, w, b = args[:3]
        x2 = x.reshape(-1, x.shape[-1])
        return lambda: torch.addmm(b, x2, w)
    if name == 'zadd_conv_kxk' or (name == 'conv_kxk_act' and len(args) > 3
                                   and not args[3]):
        x, wk, b = ((args[0].float() + args[1], *args[2:])
                    if name == 'zadd_conv_kxk' else args[:3])
        xc = x.permute(0, 3, 1, 2)
        wc = wk.permute(3, 2, 0, 1).contiguous()
        return lambda: F.conv2d(xc, wc, b, padding=(wk.shape[0] - 1) // 2)
    if name == 'zadd':
        syms, pm = args
        return lambda: torch.add(syms, pm)
    if name == 'zadd_dense':
        syms, pm, w, b = args
        z2 = (syms.float() + pm).reshape(-1, syms.shape[-1])
        return lambda: torch.addmm(b, z2, w)
    return None


def per_call_ms(torch, fn, inner, repeats=5):
    """Median over `repeats` CUDA-event timings of `inner` back-to-back
    eager calls, divided by `inner`: the device time where the card is
    busy, the host's launch time (checks, allocation, call) where not."""
    def run():
        for _ in range(inner):
            fn()
    return cuda_ms(torch, run, repeats) / inner


def graph_ms(torch, fn, inner, repeats=5):
    """Device time of one call: `inner` calls captured in one CUDA graph,
    the replay timed with CUDA events (median of `repeats`) / `inner`; no
    host work between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return cuda_ms(torch, graph.replay, repeats) / inner


def core_oracle(torch, name, args):
    """A kernel of CORE_NAMES computed on the old product core
    (gemm_kernel, the _oldcore entry points): dense_act, prior_head,
    fuse_zproj, res_dense_act and zadd_dense as they are, dense as
    dense_act without its GELU, the conv as dense_act on
    im2col_tapmajor's columns, mlp_res as fc1 without a GELU, then fc2
    with the GELU on its input (the value mlp_res's fc1 epilogue stores),
    then shortcut + y * gamma (two roundings, as the kernel's epilogue).
    Each output's sum is the same fmaf chain on both cores, so the tiled
    core must match it bitwise."""
    from lvae_tpu_torch.ops import trunk
    if name in ('dense_act', 'prior_head', 'fuse_zproj', 'res_dense_act',
                'zadd_dense'):
        return getattr(trunk, name + '_oldcore')(*args)
    if name == 'dense':
        x, w, b = args
        return trunk.dense_act_oldcore(x, w, b, False)
    if name == 'mlp_res':
        t, w1, b1, w2, b2, gamma, shortcut = args
        y = trunk.dense_act_oldcore(trunk.dense_act_oldcore(t, w1, b1, False),
                                    w2, b2, True)
        return shortcut + y * gamma
    x, wk, b = args[:3]
    act = args[3] if len(args) > 3 else True
    B, H, W, Ci = x.shape
    K, Co = wk.shape[0], wk.shape[-1]
    cols = trunk.im2col_tapmajor(x, K)
    return trunk.dense_act_oldcore(cols, wk.reshape(K * K * Ci, Co), b,
                                   act).reshape(B, H, W, Co)


def same_bits(torch, a, b):
    """Whether two tensors hold the same bits, NaNs and the sign of zero
    included (torch.equal calls a NaN unequal to itself)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.float16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def core_bitwise(torch, name, args, got=None):
    """Whether the kernel's outputs (one tensor or a tuple) equal
    core_oracle's, bit for bit."""
    from lvae_tpu_torch.ops import trunk
    if got is None:
        got = getattr(trunk, name)(*args)
    want = core_oracle(torch, name, args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(
        same_bits(torch, g, w) for g, w in zip(got, want))


# kernels held bitwise against the design they replaced, which stays as
# their oracle: emb_mlp's cluster kernel against the one-block kernel (also
# at the portable cluster of 8 CTAs), zadd_conv_kxk against zadd then the
# conv, nll_head's search against its linear count, upsample_finish and
# upsample_head against the chains of launches they fold
REDESIGN_ORACLES = ('emb_mlp', 'zadd_conv_kxk', 'nll_head') + SHUFFLE_NAMES


def replaced_design(torch, name, args):
    """The design a kernel of REDESIGN_ORACLES replaced, on the same inputs:
    emb_mlp_oneblock; zadd then conv_kxk_act(act=False), z written and read
    back; nll_head_linear; upsample_finish_chain (dense, the shuffle copy,
    finish_image and the float16 cast) and upsample_head_chain (two dense
    launches and two shuffle copies)."""
    from lvae_tpu_torch.ops import trunk
    if name == 'emb_mlp':
        return trunk.emb_mlp_oneblock(*args)
    if name == 'nll_head':
        return trunk.nll_head_linear(*args)
    if name in SHUFFLE_NAMES:
        return getattr(trunk, name + '_chain')(*args)
    syms, pm, wk, b = args
    return trunk.conv_kxk_act(trunk.zadd(syms, pm), wk, b, False)


def oracle_bitwise(torch, name, args, got=None):
    """Whether the kernel's outputs equal replaced_design's bit for bit
    (same_bits); for emb_mlp also at a cluster of 8 CTAs."""
    from lvae_tpu_torch.ops import trunk
    fn = getattr(trunk, name)
    runs = [fn(*args) if got is None else got]
    if name == 'emb_mlp':
        runs.append(trunk.emb_mlp_cluster8(*args))
    want = replaced_design(torch, name, args)
    want = want if isinstance(want, tuple) else (want,)
    return all(len(g) == len(want) and all(
        same_bits(torch, a, w) for a, w in zip(g, want))
        for g in (r if isinstance(r, tuple) else (r,) for r in runs))


def prior_table_smem():
    """The largest scale table prior_head's tiled kernel stages in shared
    memory, read from its source (csrc/trunk.cu PRIOR_TABLE_SMEM)."""
    import re
    with open(os.path.join(ROOT, 'lvae_tpu_torch', 'csrc', 'trunk.cu')) as f:
        src = f.read()
    return int(re.search(r'constexpr int PRIOR_TABLE_SMEM = (\d+);',
                         src).group(1))


def prior_tables(np, seed=CORE_SEED):
    """prior_head's synthetic scale tables, by label (float32): the codecs'
    64 entries; 64 with every value twice (ties); one entry; 65 (the
    run-time count); the codecs' in a shuffled order (the count needs no
    order); one entry past what the kernel stages in shared memory (counted
    from global memory)."""
    from lvae_tpu_torch.ops import cdf
    codec = cdf.default_gaussian_scale_table()
    return {k: v.astype(np.float32) for k, v in {
        'codec': codec, 'ties': np.repeat(codec[::2], 2), 'one': codec[:1],
        's65': cdf.default_gaussian_scale_table(n=65),
        'shuffled': np.random.default_rng(seed).permutation(codec),
        'past_smem': cdf.default_gaussian_scale_table(
            n=prior_table_smem() + 1)}.items()}


def check_prior_dense_act_synthetic(torch, device):
    """dense_act (also dense_act_staged, the GELU on the staged tile) and
    prior_head against their _oldcore oracles, bitwise (same_bits: pm, the
    scale indexes and the non-finite rows), at every M of DA_M, C of DA_C,
    act on and off, from aligned rows and rows 4 bytes off 16: dense_act at
    every N of DA_N, prior_head at every Z of PRIOR_Z with the codecs'
    table and, at the PRIOR_TABLE_* subset, with every other table of
    prior_tables. Weights at a scale and the index columns' biases spread
    over -4 .. 5, so that the scales cover the tables and pass both of
    their ends. -> (cases, mismatches, calls of the counted wrappers)."""
    import itertools
    from lvae_tpu_torch.ops import trunk
    g = torch.Generator(device=device).manual_seed(CORE_SEED)
    tables = {k: torch.as_tensor(v, device=device)
              for k, v in prior_tables(np).items()}

    def f(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=device) * scale

    def rows(M, C, unaligned):
        x = f(M * C + 1)[1:] if unaligned else f(M * C)
        x = x.reshape(1, M, C)
        if M > 1:                       # the non-finite rows
            x[0, M // 2, :3] = torch.tensor(
                [math.nan, math.inf, -math.inf], device=device)[:C]
            x[0, M - 1, 0] = math.inf
        return x

    cases, bad, counted = 0, [], 0
    for M, C in itertools.product(DA_M, DA_C):
        xs = {u: rows(M, C, u) for u in (False, True)}
        for N in DA_N:
            w, b = f(C, N, scale=C ** -0.5), f(N, scale=0.1)
            for (u, x), act in itertools.product(xs.items(), (True, False)):
                args = (x, w, b, act)
                for staged in (False, True):
                    cases += 1
                    counted += not staged
                    got = trunk.dense_act_staged(*args) if staged else None
                    if not core_bitwise(torch, 'dense_act', args, got):
                        bad.append(dict(kernel='dense_act', M=M, C=C, N=N,
                                        act=act, unaligned=u, staged=staged))
        for Z in PRIOR_Z:
            w = f(C, 2 * Z, scale=1.5 * C ** -0.5)
            b = torch.cat([f(Z, scale=0.1),
                           torch.rand(Z, generator=g, device=device) * 9 - 4])
            labels = (tables if M in PRIOR_TABLE_M and C in PRIOR_TABLE_C
                      and Z in PRIOR_TABLE_Z else ('codec',))
            for (u, x), act, label in itertools.product(
                    xs.items(), (True, False), labels):
                cases += 1
                counted += 1
                args = (x, w, b, tables[label], act)
                if not core_bitwise(torch, 'prior_head', args):
                    bad.append(dict(kernel='prior_head', M=M, C=C, Z=Z,
                                    act=act, unaligned=u, table=label))
    # the scales pass both ends of the table: on the finite rows of the
    # last case the first and the last index occur
    _, idx = trunk.prior_head(xs[False], w, b, tables['codec'], True)
    ends = [int(idx[0, :M // 2].min()), int(idx[0, :M // 2].max())]
    require(ends == [0, 63], f'prior_head synthetic scales reach indexes '
                             f'{ends} only')
    return cases, bad, counted + 1


def junction_symbols(torch, g, n, device):
    """n int32 symbols: mostly small (|s| <= 40), one in 16 escape-sized (up
    to 2^16), one in 64 anywhere in +-(2^24 - 1), the first two at both
    ends of that range (every one converts to float exactly)."""
    big = (1 << 24) - 1
    s = torch.randint(-40, 41, (n,), generator=g, device=device)
    u = torch.rand(n, generator=g, device=device)
    esc = torch.randint(-(1 << 16), (1 << 16) + 1, (n,), generator=g,
                        device=device)
    far = torch.randint(-big, big + 1, (n,), generator=g, device=device)
    s = torch.where(u < 1 / 16, esc, s)
    s = torch.where(u < 1 / 64, far, s)
    s[:2] = torch.tensor([big, -big], device=device)[:n]
    return s.to(torch.int32)


def check_junction_synthetic(torch, device, Ms=JUNCTION_M, Ks=JUNCTION_K,
                             Ns=JUNCTION_N):
    """fuse_zproj and res_dense_act (both GELU designs: the main path's on
    the staged tile and res_dense_act_prepass) against their _oldcore
    oracles, bitwise (same_bits: NaNs and the sign of zero), at every M of
    Ms, K of Ks (Z or Ci) and N of Ns, from
    aligned inputs and from inputs 4 bytes off 16 (feature, syms, pm and
    t); symbols from junction_symbols; for M > 1 row M // 2 of pm and of t
    holds NaN, +inf and -inf, row M - 1 of the feature NaN and +-inf, and
    every fifth value of its row 0 is -0. -> (cases, mismatches, calls of
    the counted wrappers)."""
    import itertools
    from lvae_tpu_torch.ops import trunk
    g = torch.Generator(device=device).manual_seed(JUNCTION_SEED)
    special = torch.tensor([math.nan, math.inf, -math.inf], device=device)

    def buf(n, unaligned):
        x = torch.randn(n + 1, generator=g, device=device)
        return x[1:] if unaligned else x[:n]

    cases, bad, counted = 0, [], 0
    for M, K in itertools.product(Ms, Ks):
        ins = {}
        for u in (False, True):
            s = junction_symbols(torch, g, M * K + 1, device)
            s = (s[1:] if u else s[:M * K]).reshape(1, M, K)
            pm, t = buf(M * K, u).reshape(1, M, K), buf(M * K, u).reshape(
                1, M, K)
            if M > 1:
                pm[0, M // 2, :3] = special[:K]
                t[0, M // 2, :3] = special[:K]
            ins[u] = (s, pm, t)
        for N in Ns:
            w = torch.randn(K, N, generator=g, device=device) * K ** -0.5
            b = torch.randn(N, generator=g, device=device) * 0.1
            for u, (s, pm, t) in ins.items():
                f = buf(M * N, u).reshape(1, M, N)
                f[0, 0, ::5] = -0.0
                if M > 1:
                    f[0, M - 1, :3] = special[:N]
                # (label, kernel, oracle, whether the kernel is counted)
                for label, got, oracle, main in (
                        ('fuse_zproj', lambda: trunk.fuse_zproj(f, s, pm, w, b),
                         lambda: trunk.fuse_zproj_oldcore(f, s, pm, w, b),
                         True),
                        ('res_dense_act', lambda: trunk.res_dense_act(
                            f, t, w, b),
                         lambda: trunk.res_dense_act_oldcore(f, t, w, b),
                         True),
                        ('res_dense_act_prepass',
                         lambda: trunk.res_dense_act_prepass(f, t, w, b),
                         lambda: trunk.res_dense_act_oldcore(f, t, w, b),
                         False)):
                    cases += 1
                    counted += main
                    if not same_bits(torch, got(), oracle()):
                        bad.append(dict(kernel=label, M=M, K=K, N=N,
                                        unaligned=u))
    return cases, bad, counted


def check_core_synthetic(torch, device):
    """dense, conv_kxk_act and mlp_res against core_oracle, bitwise, on
    synthetic ragged shapes: every M of CORE_M, N of CORE_N, Ci of CORE_CI
    and K of CORE_K; dense at depth K*K*Ci, also from a row pointer 4 bytes
    off 16 (the 4-byte copies); the conv with act on and off (Ci 10 and 14
    take the 4-byte copies); mlp_res at every M of MLP_M, C of MLP_C and
    hidden ratio of MLP_RATIOS, at MLP_CO_CASE and MLP_HID_RAGGED_CASE,
    and once from unaligned rows."""
    import itertools
    rng = np.random.default_rng(CORE_SEED)

    def f(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(
            np.float32), device=device)

    cases, bad = 0, []
    for M, N, Ci, K in itertools.product(CORE_M, CORE_N, CORE_CI, CORE_K):
        C = K * K * Ci
        w, b = f(C, N, scale=C ** -0.5), f(N)
        x = f(1, M, C)
        unaligned = f(M * C + 1)[1:].reshape(1, M, C)
        for what, xd in (('dense', x), ('dense, unaligned rows', unaligned)):
            cases += 1
            if not core_bitwise(torch, 'dense', (xd, w, b)):
                bad.append(dict(kernel=what, M=M, N=N, C=C))
        wk = f(K, K, Ci, N, scale=C ** -0.5)
        xi = f(*CORE_M[M], Ci)
        for act in (True, False):
            cases += 1
            if not core_bitwise(torch, 'conv_kxk_act', (xi, wk, b, act)):
                bad.append(dict(kernel='conv_kxk_act', M=M, N=N, Ci=Ci,
                                K=K, act=act))
    mlp = [(M, C, round(C * r), C) for M, C, r in itertools.product(
        MLP_M, MLP_C, MLP_RATIOS)] + [MLP_CO_CASE, MLP_HID_RAGGED_CASE]
    for i, (M, C, HID, CO) in enumerate(mlp + [MLP_CO_CASE]):
        unaligned = i == len(mlp)
        t = (f(M * C + 1)[1:].reshape(1, M, C) if unaligned
             else f(1, M, C))
        args = (t, f(C, HID, scale=C ** -0.5), f(HID),
                f(HID, CO, scale=HID ** -0.5), f(CO), f(CO, scale=0.1),
                f(1, M, CO))
        cases += 1
        if not core_bitwise(torch, 'mlp_res', args):
            bad.append(dict(kernel='mlp_res', M=M, C=C, HID=HID, CO=CO,
                            unaligned=unaligned))
    more, more_bad, _ = check_prior_dense_act_synthetic(torch, device)
    cases += more
    bad += more_bad
    t0 = time.perf_counter()
    junction, junction_bad, _ = check_junction_synthetic(torch, device)
    junction_s = time.perf_counter() - t0
    cases += junction
    bad += junction_bad
    progress(f'tiled core, synthetic shapes: {cases} cases, {len(bad)} not '
             f'bitwise equal to the old core')
    require(not bad, f'tiled core not bitwise equal to the old core at '
                     f'{bad[:5]}')
    return dict(cases=cases, bitwise=True, M=list(CORE_M), N=list(CORE_N),
                Ci=list(CORE_CI), K=list(CORE_K), acts=[True, False],
                mlp_res_shapes=[list(m) for m in mlp],
                dense_act_prior_head=dict(
                    cases=more, M=list(DA_M), C=list(DA_C), N=list(DA_N),
                    Z=list(PRIOR_Z), tables={k: len(v) for k, v in
                                             prior_tables(np).items()},
                    table_subset=dict(M=list(PRIOR_TABLE_M),
                                      C=list(PRIOR_TABLE_C),
                                      Z=list(PRIOR_TABLE_Z)),
                    non_finite_rows='M // 2: NaN, +inf, -inf; M - 1: +inf'),
                fuse_zproj_res_dense_act=dict(
                    cases=junction, seconds=junction_s, M=list(JUNCTION_M),
                    K=list(JUNCTION_K), N=list(JUNCTION_N),
                    unaligned='feature, syms, pm and t 4 bytes off 16',
                    symbols='|s| <= 40; 1/16 up to 2^16; 1/64 up to '
                            '2^24 - 1; both ends of +-(2^24 - 1)',
                    non_finite='pm and t row M // 2: NaN, +inf, -inf; '
                               'feature row M - 1: NaN, +inf, -inf; '
                               'feature row 0: -0 every fifth value',
                    designs='res_dense_act: the GELU on the staged tile '
                            'and res_dense_act_prepass'),
                oracle='dense_act_oldcore (conv: on im2col_tapmajor '
                       'columns; mlp_res: fc1, then fc2 with the GELU on '
                       'its input, then the residual); prior_head, '
                       'fuse_zproj, res_dense_act: their _oldcore entry '
                       'points')


def warp_oracle(name):
    """The warp-per-pixel kernel of dw_ln_mod or dw_ln_affine."""
    from lvae_tpu_torch.ops import trunk
    return getattr(trunk, name + '_warp')


def warp_bitwise(torch, name, args, got=None):
    """Whether the halo-tile kernel's output equals the warp-per-pixel
    kernel's, bit for bit."""
    from lvae_tpu_torch.ops import trunk
    if got is None:
        got = getattr(trunk, name)(*args)
    return bool(torch.equal(got, warp_oracle(name)(*args)))


def two_calls(torch, name, args):
    """The stencil pair's yardstick, two PyTorch calls (no single one
    computes the function): F.conv2d(groups=C) on a channels-last view, then
    F.layer_norm over C (dw_ln_affine's with its affine; dw_ln_mod's without,
    the modulation left out). Weights in torch's layout, made outside the
    calls; time them with TF32 off."""
    import torch.nn.functional as F
    x, dwk, dwb = args[:3]
    K, C = args[-1], x.shape[-1]
    xc = x.permute(0, 3, 1, 2)
    wc = dwk.permute(2, 0, 1).reshape(C, 1, K, K).contiguous()
    affine = args[3:5] if name == 'dw_ln_affine' else (None, None)

    def run():
        y = F.conv2d(xc, wc, dwb, padding=(K - 1) // 2, groups=C)
        return F.layer_norm(y.permute(0, 2, 3, 1), (C,), *affine, eps=1e-6)
    return run


def check_dw_synthetic(torch, device):
    """dw_ln_mod and dw_ln_affine against their warp-per-pixel kernels,
    bitwise, at every H and W of DW_HW, C of DW_C and K of DW_K; inputs from
    a seeded generator on the card."""
    import itertools
    g = torch.Generator(device=device).manual_seed(DW_SEED)

    def f(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=device) * scale

    cases, bad = 0, []
    for name, H, W, C, K in itertools.product(DW_NAMES, DW_HW, DW_HW, DW_C,
                                              DW_K):
        variants = [(1, False)] + ([(2, True)] if (H, W) == (13, 130)
                                   else [])
        for B, unaligned in variants:
            x = (f(B * H * W * C + 1)[1:].reshape(B, H, W, C) if unaligned
                 else f(B, H, W, C))
            dwk, dwb = f(K, K, C, scale=0.3), f(C, scale=0.1)
            args = ((x, dwk, dwb, f(64, 2 * C, scale=0.2),
                     f(2 * C, scale=0.1), f(B, 64), K)
                    if name == 'dw_ln_mod' else
                    (x, dwk, dwb, f(C, scale=0.5) + 1, f(C, scale=0.1), K))
            cases += 1
            if not warp_bitwise(torch, name, args):
                bad.append(dict(kernel=name, B=B, H=H, W=W, C=C, K=K,
                                unaligned=unaligned))
    torch.cuda.synchronize()
    progress(f'stencil pair, synthetic shapes: {cases} cases, {len(bad)} '
             f'not bitwise equal to the warp-per-pixel kernel')
    require(not bad, f'halo-tile stencil not bitwise equal to the '
                     f'warp-per-pixel kernel at {bad[:5]}')
    return dict(cases=cases, bitwise=True, H=list(DW_HW), W=list(DW_HW),
                C=list(DW_C), K=list(DW_K),
                unaligned='B = 2 from an input 4 bytes off 16 at 13 x 130, '
                          'every C and K',
                oracle='the warp-per-pixel kernel (trunk_dw_ln_mod_warp, '
                       'trunk_dw_ln_affine_warp)')


def zconv_args(torch, g, B, H, W, Z, Co, unaligned, device):
    """zadd_conv_kxk's arguments (syms, pm, wk, b) at (B, H, W, Z) into Co
    channels, 3x3, from the generator g: junction_symbols; pm normal with
    -0 in every fifth value and, where there are two pixels or more, NaN,
    +inf and -inf at the middle pixel; syms and pm 4 bytes off 16 where
    `unaligned`."""
    n = B * H * W * Z
    s = junction_symbols(torch, g, n + 1, device)
    pm = torch.randn(n + 1, generator=g, device=device)
    s, pm = (s[1:], pm[1:]) if unaligned else (s[:n], pm[:n])
    pm[::5] = -0.0
    if B * H * W > 1:
        mid = (B * H * W // 2) * Z
        pm[mid:mid + min(Z, 3)] = torch.tensor(
            [math.nan, math.inf, -math.inf], device=device)[:Z]
    wk = torch.randn(3, 3, Z, Co, generator=g, device=device) * (
        9 * Z) ** -0.5
    return (s.reshape(B, H, W, Z), pm.reshape(B, H, W, Z), wk,
            torch.randn(Co, generator=g, device=device) * 0.1)


def f64_witness(torch, args, outs):
    """Where the outputs `outs` of zadd_conv_kxk's function on `args` lie
    against its float64 value: z = syms + pm in float32 (zadd), then the
    conv in float64. Any float32 summation order of the n = K*K*Z + 1 terms
    (products and the bias) lies within gamma_n * (sum |w||z| + |b|) of it,
    gamma_n = n*u / (1 - n*u), u = 2^-24 (Higham, the inner product bound;
    plus float64's own). -> [(largest share of that bound, max abs err)]
    an output; where the float64 value is not finite, the output must be
    the same NaN or infinity, else the share is inf."""
    import torch.nn.functional as F
    from lvae_tpu_torch.ops import trunk
    syms, pm, wk, b = args
    z = trunk.zadd_plain(syms, pm).double()
    B, H, W, _ = z.shape
    K, Z, Co = wk.shape[0], wk.shape[2], wk.shape[3]
    p = (K - 1) // 2
    zp = F.pad(z, (0, 0, p, p, p, p))
    exact = b.double().expand(B, H, W, Co).clone()
    mag = exact.abs()
    for di in range(K):
        for dj in range(K):
            tap, w = zp[:, di:di + H, dj:dj + W], wk[di, dj].double()
            exact += tap @ w
            mag += tap.abs() @ w.abs()
    n = K * K * Z + 1
    bound = sum(n * u / (1 - n * u) for u in (2.0 ** -24, 2.0 ** -53)) * mag
    fin = torch.isfinite(exact)
    res = []
    for y in outs:
        y = y.double()
        inf = torch.isinf(exact)
        same = bool(torch.equal(torch.isnan(y), torch.isnan(exact))
                    and torch.equal(y[inf], exact[inf]))
        d, bd = (y - exact)[fin].abs(), bound[fin]
        share = torch.where(bd > 0, d / bd.clamp_min(1e-300),
                            (d > 0).double() * math.inf)
        res.append((float(share.max()) if same and d.numel() else
                    (0.0 if same else math.inf),
                    float(d.max()) if d.numel() else 0.0))
    return res


def zconv_cases():
    """(B, H, W, Z, Co, unaligned) of zadd_conv_kxk's synthetic check."""
    import itertools
    cases = [(B, H, W, Z, Co, False) for (H, W, Z), B, Co in
             itertools.product(ZCONV_MAIN, ZCONV_B, ZCONV_CO)]
    return cases + [(1, H, W, Z, Co, u) for H, W, Z, Co in itertools.product(
        ZCONV_HW, ZCONV_HW, ZCONV_Z, ZCONV_CO)
        for u in ((False, True) if Z % 4 == 0 else (False,))]


def check_emb_zadd_synthetic(torch, device):
    """emb_mlp (cluster kernel) against emb_mlp_oneblock and zadd_conv_kxk
    against zadd then conv_kxk_act(act=False), bitwise (same_bits), at the
    shapes of EMB_* and ZCONV_* (inputs from seeded generators on the
    card); emb_mlp's device times at qarv_base's widths, B = 1 and 6."""
    import itertools
    from lvae_tpu_torch.ops import trunk
    g = torch.Generator(device=device).manual_seed(ZCONV_SEED)

    def f(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=device) * scale

    cases, bad, times = 0, [], {}
    for E0, E in EMB_WIDTHS:
        # the weights as the model passes them: .t() views of torch's
        # (out, in) Linear weights, which the wrapper reads without a copy
        w = (torch.as_tensor(trunk.emb_freqs(E0, 64), device=device),
             f(E, E0, scale=E0 ** -0.5).t(), f(E, scale=0.1),
             f(E, E, scale=E ** -0.5).t(), f(E, scale=0.1), 64)
        for B, cl in itertools.product(EMB_B, EMB_CLUSTERS):
            lmb = torch.tensor([EMB_LAMBDAS[i % len(EMB_LAMBDAS)]
                                for i in range(B)], device=device)
            cases += 1
            got = getattr(trunk, EMB_CLUSTERS[cl])(lmb, *w)
            want = trunk.emb_mlp_oneblock(lmb, *w)
            if not all(same_bits(torch, a, b) for a, b in zip(got, want)):
                bad.append(dict(kernel='emb_mlp', E0=E0, E=E, B=B,
                                cluster=cl))
        if (E0, E) == (256, 256):
            for B in (1, 6):
                lmb = torch.tensor(EMB_LAMBDAS[:B], device=device)
                times[f'B{B}'] = {
                    f'cluster{cl}_ms': graph_ms(
                        torch, lambda: getattr(trunk, fn)(lmb, *w),
                        TRUNK_INNER) for cl, fn in EMB_CLUSTERS.items()}
                times[f'B{B}']['oneblock_ms'] = graph_ms(
                    torch, lambda: trunk.emb_mlp_oneblock(lmb, *w),
                    TRUNK_INNER)
    zcases = zconv_cases()
    # the kernel and the plain version against the float64 value (their
    # summation orders differ, so they differ by rounding): the largest
    # share of the rounding bound and the max abs err, each
    f64 = dict(kernel=[0.0, 0.0], plain=[0.0, 0.0])
    for c in zcases:
        cases += 1
        args = zconv_args(torch, g, *c, device)
        got = trunk.zadd_conv_kxk(*args)
        if not oracle_bitwise(torch, 'zadd_conv_kxk', args, got):
            bad.append(dict(zip(('kernel', 'B', 'H', 'W', 'Z', 'Co',
                                 'unaligned'), ('zadd_conv_kxk',) + c)))
        for key, r in zip(f64, f64_witness(
                torch, args, (got, trunk.zadd_conv_kxk_plain(*args)))):
            f64[key] = [max(a, b) for a, b in zip(f64[key], r)]
    torch.cuda.synchronize()
    progress(f'emb_mlp and zadd_conv_kxk, synthetic shapes: {cases} cases, '
             f'{len(bad)} not bitwise equal to their oracles; emb_mlp at '
             f'256: {times}; zadd_conv_kxk against float64: {f64}')
    require(not bad, f'emb_mlp / zadd_conv_kxk not bitwise equal to their '
                     f'oracles at {bad[:5]}')
    require(all(r[0] <= 1.0 for r in f64.values()),
            f'zadd_conv_kxk or its plain version past the float32 rounding '
            f'bound of the float64 value: {f64}')
    return dict(cases=cases, bitwise=True,
                emb_mlp=dict(widths=[list(w) for w in EMB_WIDTHS],
                             B=list(EMB_B), clusters=list(EMB_CLUSTERS),
                             lambdas=list(EMB_LAMBDAS),
                             oracle='emb_mlp_oneblock',
                             qarv_base_times=times),
                zadd_conv_kxk=dict(
                    cases=len(zcases), main_shapes=[list(m) for m in
                                                    ZCONV_MAIN],
                    B=list(ZCONV_B), Co=list(ZCONV_CO), H=list(ZCONV_HW),
                    W=list(ZCONV_HW), Z=list(ZCONV_Z), K=3,
                    unaligned='Z % 4 == 0: syms and pm 4 bytes off 16',
                    symbols='junction_symbols: up to +-(2^24 - 1)',
                    pm='-0 every fifth value; NaN, +inf, -inf at the '
                       'middle pixel',
                    oracle='zadd then conv_kxk_act(act=False)',
                    f64_witness={k: dict(bound_share=v[0], max_abs_err=v[1])
                                 for k, v in f64.items()},
                    f64_bound='gamma_n (sum |w||z| + |b|), n = K*K*Z + 1, '
                              'u = 2^-24, z = syms + pm in float32'))


# ---- nll_head's search and zadd_dense on the tiled core ---------------------

def nll_search_cases(torch, S, device):
    """nll_head's synthetic cases at table size S: -> [(label, (p_mean,
    p_scale_raw, table, bin_size 1/127.5))]. Raw scales r normal (sd 4)
    about -4.5, the first four +inf, NaN, 100 (its scale overflows to +inf)
    and -inf (below any table); means on the pixel grid's half-points, two
    of them +-inf.
    Tables: 'linspace' (exp of a linspace, as the head's); 'at_scales', S
    sorted scales of these r (from the middle 90 %, so that some lie below
    the first entry and some above the last): a scale at every entry;
    'ulp_up' and 'ulp_down', each of its entries one ulp up or down: a
    scale one ulp below or above every entry; 'ties', every third entry of
    at_scales three times in a row. Each table with NLL_N elements from
    aligned pointers (the four-element path), the first NLL_N - 3 (n % 4
    != 0) and those 4 bytes off 16 (the one-element path)."""
    from lvae_tpu_torch.ops import trunk
    rng = np.random.default_rng(NLL_SEED + S)
    n = NLL_N
    r = rng.normal(-4.5, 4.0, n).astype(np.float32)
    r[:4] = [math.inf, math.nan, 100.0, -math.inf]
    m = ((rng.integers(-3, 259, n) + 0.5) / 127.5 - 1).astype(np.float32)
    m += rng.integers(-3, 4, n) * np.spacing(m)
    m[4:6] = [math.inf, -math.inf]
    r_t = torch.as_tensor(r, device=device)
    # the scales the kernel compares, before the clamp by the first entry
    scales = trunk.nll_scales_plain(
        r_t, r_t, torch.zeros(1, device=device), 1 / 127.5)[1]
    pool = scales.cpu().numpy()
    pool = np.sort(pool[np.isfinite(pool)])
    pool = pool[len(pool) // 20:len(pool) - len(pool) // 20]
    at = np.sort(rng.choice(pool, S, replace=False)).astype(np.float32)
    tables = {'linspace': np.exp(np.linspace(math.log(0.11), math.log(20.0),
                                             S)).astype(np.float32),
              'at_scales': at,
              'ulp_up': np.nextafter(at, np.float32(np.inf)),
              'ulp_down': np.nextafter(at, np.float32(-np.inf)),
              'ties': np.repeat(at[::3], 3)[:S]}
    out = []
    for label, table in tables.items():
        trunk.require_nondecreasing(table)
        tb = torch.as_tensor(table, device=device)
        for path, lo, k in (('aligned', 0, n), ('odd_n', 0, n - 3),
                            ('unaligned', 1, n - 3)):
            bufs = []
            for a in (m, r):
                buf = torch.empty(n + 1, device=device)
                buf[lo:lo + k] = torch.as_tensor(a[:k], device=device)
                bufs.append(buf[lo:lo + k])
            out.append((f'{label} {path}', (*bufs, tb, 1 / 127.5)))
    return out


def zadd_dense_args(torch, g, B, M, Z, CO, unaligned, device):
    """zadd_dense's arguments (syms, pm, w, b) at (B, M, Z) into CO columns
    from the generator g: junction_symbols; pm normal with -0 in every fifth
    value and, where M > 1, NaN, +inf and -inf in row M // 2 of the first
    image; syms and pm 4 bytes off 16 where `unaligned`."""
    n = B * M * Z
    s = junction_symbols(torch, g, n + 1, device)
    pm = torch.randn(n + 1, generator=g, device=device)
    s, pm = (s[1:], pm[1:]) if unaligned else (s[:n], pm[:n])
    pm[::5] = -0.0
    if M > 1:
        row = (M // 2) * Z
        pm[row:row + min(Z, 3)] = torch.tensor(
            [math.nan, math.inf, -math.inf], device=device)[:Z]
    # w (Z, CO) as the model passes it: the .t() view of a (CO, Z) weight
    w = torch.randn(CO, Z, generator=g, device=device).t() * Z ** -0.5
    return (s.reshape(B, M, Z), pm.reshape(B, M, Z), w,
            torch.randn(CO, generator=g, device=device) * 0.1)


def zadd_dense_cases():
    """(B, M, Z, CO, unaligned) of zadd_dense's synthetic check."""
    import itertools
    return [(1, M, Z, CO, u) for M, Z, CO, u in itertools.product(
        ZDENSE_M, ZDENSE_Z, ZDENSE_CO, (False, True))]


def nll_head_bitwise(torch, args, got=None):
    """Whether nll_head (or its outputs `got`), nll_head_linear and
    nll_head_plain give the same pm (same_bits) and indexes on args."""
    from lvae_tpu_torch.ops import trunk
    outs = [trunk.nll_head(*args) if got is None else got]
    outs += [fn(*args) for fn in (trunk.nll_head_linear, trunk.nll_head_plain)]
    return all(same_bits(torch, a, b) for o in outs[1:]
               for a, b in zip(outs[0], o))


def hold_redesigns(torch, names, cases):
    """zadd_dense (against the old core), nll_head (against
    nll_head_linear and its plain version), upsample_finish and
    upsample_head (against their chains), bitwise, at every shape captured
    from one encode and decode of each (label, encode, decode) of `cases`;
    where a shape holds B >= 2 images, each image also against its bits
    alone. -> {name: {label: shapes held}}."""
    from lvae_tpu_torch.ops import trunk
    out = {n: {} for n in names}
    for label, encode, decode in cases:
        inputs, _ = capture_trunk_inputs(encode, decode, names)
        for name in names:
            fn = getattr(trunk, name)
            for sig, args in inputs[name].items():
                got = fn(*args)
                ok = (nll_head_bitwise(torch, args, got) if name == 'nll_head'
                      else oracle_bitwise(torch, name, args, got)
                      if name in SHUFFLE_NAMES
                      else core_bitwise(torch, name, args, got))
                got = got if isinstance(got, tuple) else (got,)
                for b in range(1, args[0].shape[0]):
                    one = [a[b:b + 1] if i in PER_IMAGE_ARGS[name] else a
                           for i, a in enumerate(args)]
                    alone = fn(*one)
                    alone = alone if isinstance(alone, tuple) else (alone,)
                    ok = ok and all(same_bits(torch, g[b:b + 1], a)
                                    for g, a in zip(got, alone))
                require(ok, f'{name} at {label} shapes {sig}: not bitwise '
                            f'equal to its oracle, or an image of the batch '
                            f'not to its bits alone')
            out[name][label] = len(inputs[name])
            require(inputs[name], f'{name}: no call captured in {label}')
    progress(f'redesigns held at captured shapes: {out}')
    return out


def check_nll_zadd_synthetic(torch, device):
    """nll_head against nll_head_linear and nll_head_plain (pm and indexes
    bitwise) on nll_search_cases at every S of NLL_S, and zadd_dense against
    zadd_dense_oldcore (same_bits) on zadd_dense_cases, each counted
    wrapper one launch a call."""
    from lvae_tpu_torch.ops import trunk
    cases, bad = 0, []
    before = trunk.nll_head.launches, trunk.zadd_dense.launches
    for S in NLL_S:
        for label, args in nll_search_cases(torch, S, device):
            cases += 1
            if not nll_head_bitwise(torch, args):
                bad.append(dict(kernel='nll_head', S=S, case=label))
    n_nll = cases
    g = torch.Generator(device=device).manual_seed(ZDENSE_SEED)
    for c in zadd_dense_cases():
        cases += 1
        args = zadd_dense_args(torch, g, *c, device)
        if not same_bits(torch, trunk.zadd_dense(*args),
                         trunk.zadd_dense_oldcore(*args)):
            bad.append(dict(zip(('kernel', 'B', 'M', 'Z', 'CO', 'unaligned'),
                                ('zadd_dense',) + c)))
    torch.cuda.synchronize()
    launches = (trunk.nll_head.launches - before[0],
                trunk.zadd_dense.launches - before[1])
    progress(f'nll_head and zadd_dense, synthetic cases: {cases}, '
             f'{len(bad)} not bitwise equal to their oracles; launches '
             f'{launches}')
    require(not bad, f'nll_head / zadd_dense not bitwise equal to their '
                     f'oracles at {bad[:5]}')
    require(launches == (n_nll, cases - n_nll),
            f'nll_head / zadd_dense launches {launches}, expected one a '
            f'call')
    return dict(
        cases=cases, bitwise=True,
        nll_head=dict(cases=n_nll, S=list(NLL_S), n=NLL_N,
                      tables=['linspace', 'at_scales', 'ulp_up',
                              'ulp_down', 'ties'],
                      paths=['aligned', 'odd_n', 'unaligned'],
                      oracle='nll_head_linear and nll_head_plain'),
        zadd_dense=dict(cases=cases - n_nll, M=list(ZDENSE_M),
                        Z=list(ZDENSE_Z), CO=list(ZDENSE_CO),
                        unaligned='syms and pm 4 bytes off 16',
                        symbols='junction_symbols: up to +-(2^24 - 1)',
                        oracle='zadd_dense_oldcore'))


def shuffle_args(torch, g, name, B, H, W, C, rate, unaligned, device):
    """One synthetic input of upsample_finish / upsample_head: x (B, H, W,
    C) normal (rows 4 bytes off 16 when `unaligned`), each conv's weight (C,
    3 rate^2) at 1/sqrt(C) and bias; every even bias column a special value
    (float16 ties of the finish, finish_value(v) = 0.5 + odd * 2^-12 and
    0.25 + odd * 2^-13; +-1; NaN; +-inf; +-0); where M >= 3, row 0 zero (the
    outputs the bias alone: the specials reach the store as they are), row
    M // 2 cycling NaN, +inf, -inf, +1, -1 and the last row +-1."""
    M, G = B * H * W, 3 * rate * rate
    x = torch.randn(M * C + 1, generator=g, device=device)
    x = (x[1:] if unaligned else x[:-1]).reshape(M, C)
    if M >= 3:
        x[0] = 0.0
        x[M // 2] = torch.tensor(
            [math.nan, math.inf, -math.inf, 1.0, -1.0] * C,
            device=device)[:C]
        x[-1] = torch.where(torch.arange(C, device=device) % 3 == 0, -1.0,
                            1.0)
    specials = torch.tensor(
        [2.0 ** -11, 3 * 2.0 ** -11, -0.5 + 2.0 ** -12, -0.5 + 3 * 2.0 ** -12,
         1.0, -1.0, math.nan, math.inf, -math.inf, 0.0, -0.0], device=device)
    args = [x.reshape(B, H, W, C)]
    for _ in range(1 if name == 'upsample_finish' else 2):
        w = torch.randn(C, G, generator=g, device=device) * C ** -0.5
        b = torch.randn(G, generator=g, device=device) * 0.5
        even = torch.arange(0, G, 2, device=device)
        b[even] = specials[(even // 2 + G) % specials.numel()]
        args += [w, b]
    return args + [rate]


def check_shuffle_synthetic(torch, device):
    """upsample_finish and upsample_head bitwise against their chains
    (same_bits) on shuffle_args' inputs: every grid of SHUFFLE_GRIDS, C of
    SHUFFLE_C, rate of SHUFFLE_RATES, at rate 4 also from rows 4 bytes off
    16 (C % 4 == 0: the 4-byte copies by alignment; C = 10 by depth); where
    B >= 2, each image against its bits alone; each counted wrapper one
    launch a call."""
    from lvae_tpu_torch.ops import trunk
    g = torch.Generator(device=device).manual_seed(SHUFFLE_SEED)
    cases, bad = 0, []
    before = {n: getattr(trunk, n).launches for n in SHUFFLE_NAMES}
    calls = dict.fromkeys(SHUFFLE_NAMES, 0)
    for B, H, W in SHUFFLE_GRIDS:
        for C in SHUFFLE_C:
            for rate in SHUFFLE_RATES:
                for unaligned in ((False, True) if rate == 4 and C % 4 == 0
                                  else (False,)):
                    for name in SHUFFLE_NAMES:
                        cases += 1
                        fn = getattr(trunk, name)
                        args = shuffle_args(torch, g, name, B, H, W, C, rate,
                                            unaligned, device)
                        got = fn(*args)
                        calls[name] += 1
                        ok = oracle_bitwise(torch, name, args, got)
                        got = got if isinstance(got, tuple) else (got,)
                        for b in range(B if B > 1 else 0):
                            alone = fn(args[0][b:b + 1], *args[1:])
                            calls[name] += 1
                            alone = (alone if isinstance(alone, tuple)
                                     else (alone,))
                            ok = ok and all(same_bits(torch, o[b:b + 1], a)
                                            for o, a in zip(got, alone))
                        if not ok:
                            bad.append(dict(kernel=name, grid=[B, H, W], C=C,
                                            rate=rate, unaligned=unaligned))
    torch.cuda.synchronize()
    launches = {n: getattr(trunk, n).launches - before[n]
                for n in SHUFFLE_NAMES}
    progress(f'upsample_finish / upsample_head, synthetic cases: {cases}, '
             f'{len(bad)} not bitwise equal to their chains; launches '
             f'{launches}')
    require(not bad, f'upsample_finish / upsample_head not bitwise equal to '
                     f'their chains (or an image to its bits alone) at '
                     f'{bad[:5]}')
    require(launches == calls, f'upsample_finish / upsample_head launches '
                               f'{launches}, expected one a call: {calls}')
    return dict(cases=cases, bitwise=True, grids=[list(t) for t in
                                                  SHUFFLE_GRIDS],
                C=list(SHUFFLE_C), rates=list(SHUFFLE_RATES),
                unaligned='rows 4 bytes off 16 at rate 4, C % 4 == 0',
                specials='float16 ties, +-1, NaN, +-inf and +-0 in the '
                         'bias of zero rows; NaN/inf and +-1 rows',
                oracle='upsample_finish_chain, upsample_head_chain',
                launches=launches)


def check_golden(torch, models, card):
    """Decode the golden portable streams of tests/golden/ (written on the
    card by an earlier commit, scripts/write-golden-streams.py; never
    written here) with decompress_file, and require the sha256 recorded for
    each: of qarv_base's float16 image and of qres34m_lossless's uint8
    pixels, which must also be the crop's own. models: {stream key: model
    in its portable compress_mode}; card: this run's versions. On a
    mismatch the recorded and the current versions are printed first."""
    import hashlib
    from lvae_tpu_torch.utils import coding

    def sha(data):
        return hashlib.sha256(data).hexdigest()

    with open(os.path.join(GOLDEN, 'golden.json')) as f:
        recorded = json.load(f)
    out = {}
    for key, model in models.items():
        want = recorded['streams'][key]
        path = os.path.join(GOLDEN, want['file'])
        with open(path, 'rb') as f:
            file_ok = sha(f.read()) == want['file_sha256']
        img = model.decompress_file(path)
        if key == 'qres34m_lossless':
            data = np.rint(img * 255.0).astype(np.uint8)
            n = want['crop'][0]
            crop = coding.read_png(os.path.join(ROOT, want['image']))[:n, :n]
            pixels_ok = (np.array_equal(data.astype(np.float32) / 255.0, img)
                         and sha(np.ascontiguousarray(crop[None]).tobytes())
                         == want['pixels_sha256'] == want['output_sha256'])
        else:
            data = img.astype(np.float16)
            pixels_ok = bool(np.array_equal(data.astype(np.float32), img))
        got = sha(np.ascontiguousarray(data).tobytes())
        out[key] = dict(file=os.path.relpath(path, ROOT), file_intact=file_ok,
                        output_sha256=got, recorded=want['output_sha256'],
                        match=got == want['output_sha256'] and pixels_ok)
        progress(f'golden {key}: output sha256 {got[:16]}.. match '
                 f'{out[key]["match"]}')
    if not all(r['match'] and r['file_intact'] for r in out.values()):
        emit({'golden_mismatch': dict(
            recorded=dict(recorded['card'], commit=recorded['commit']),
            current=card, streams=out)})
    for key, r in out.items():
        require(r['file_intact'], f'golden {key}: the committed file changed')
        require(r['match'], f'golden {key}: the stream written by '
                            f'{recorded["commit"][:7]} decodes to other '
                            f'bits')
    return dict(written_by=recorded['commit'], recorded_card=recorded['card'],
                streams=out)


# the other designs and yardsticks timed beside a main-path call
DESIGN_KEYS = ('product_ms', 'staged_gelu_ms', 'prepass_ms', 'addmm_ms',
               'cluster8_ms', 'conv_alone_ms', 'search_library_ms')


def design_times(torch, name, args):
    """{key of DESIGN_KEYS: device ms} of one main-path call's other
    designs, on the same inputs: for prior_head its product without the
    index epilogue (product_ms: dense_act_staged, its GELU on the staged
    tile as prior_head applies it); for dense_act with its GELU, the
    one-launch design its pre-pass was measured against (staged_gelu_ms:
    dense_act_staged); for res_dense_act the GELU design it does not take
    (prepass_ms: res_dense_act_prepass); for fuse_zproj
    and res_dense_act the addmm yardstick (addmm_ms: torch.addmm(feature,
    a, w), TF32 off, on its operand a computed beforehand, syms.float() +
    pm or the plain _gelu(t): the product and the residual in one library
    call, without the bias and the prologue); for emb_mlp its cluster kernel
    at the portable 8 CTAs (cluster8_ms); for zadd_conv_kxk the conv alone on z
    computed beforehand (conv_alone_ms: conv_kxk_act(act=False), the launch
    it replaced without zadd's); for nll_head the library's search alone
    (search_library_ms: torch.searchsorted(table[:-1], scales), the scales
    computed beforehand: a yardstick of the index count, not of the
    function)."""
    from lvae_tpu_torch.ops import trunk
    out = {}
    if name == 'emb_mlp':
        out['cluster8_ms'] = graph_ms(
            torch, lambda: trunk.emb_mlp_cluster8(*args), TRUNK_INNER)
    if name == 'nll_head':
        _, pv, _ = trunk.nll_scales_plain(*args)
        head = args[2][:-1]
        out['search_library_ms'] = graph_ms(
            torch, lambda: torch.searchsorted(head, pv), TRUNK_INNER)
    if name == 'zadd_conv_kxk':
        z = trunk.zadd_plain(*args[:2])
        out['conv_alone_ms'] = graph_ms(torch, lambda: trunk.conv_kxk_act(
            z, *args[2:], False), TRUNK_INNER)
    if name == 'prior_head':
        x, w, b = args[:3]
        act = args[4] if len(args) > 4 else False
        out['product_ms'] = graph_ms(
            torch, lambda: trunk.dense_act_staged(x, w, b, act), TRUNK_INNER)
    if name == 'dense_act' and (args[3] if len(args) > 3 else True):
        x, w, b = args[:3]
        out['staged_gelu_ms'] = graph_ms(torch, lambda: trunk.dense_act_staged(
            x, w, b, True), TRUNK_INNER)
    if name == 'res_dense_act':
        out['prepass_ms'] = graph_ms(
            torch, lambda: trunk.res_dense_act_prepass(*args), TRUNK_INNER)
    if name in ('fuse_zproj', 'res_dense_act'):
        f, w = args[0], args[-2]
        a = (args[1].float() + args[2] if name == 'fuse_zproj'
             else trunk._gelu(args[1]))
        f2, a2 = f.reshape(-1, f.shape[-1]), a.reshape(-1, a.shape[-1])
        out['addmm_ms'] = graph_ms(torch, lambda: torch.addmm(f2, a2, w),
                                   TRUNK_INNER)
    return out


def zadd_oracle(torch, args):
    """zadd, which zadd_conv_kxk replaced (with conv_kxk_act(act=False)
    after it, that kernel's oracle), on the (syms, pm) of one of its calls:
    its error against zadd_plain, its device time, the plain version's and
    torch.add's, and its work. zadd runs on no main path."""
    from lvae_tpu_torch.ops import trunk
    sub = args[:2]
    _, err, worst, _, _ = compare_trunk_kernel(torch, 'zadd', sub)
    require(worst <= 1.0, 'zadd disagrees with its plain version')
    nbytes, ops = work('zadd', sub)
    return dict(max_abs_err=err, ms=graph_ms(
        torch, lambda: trunk.zadd(*sub), TRUNK_INNER), plain_ms=graph_ms(
        torch, lambda: trunk.zadd_plain(*sub), TRUNK_PLAIN_INNER, repeats=3),
        library_ms=graph_ms(torch, library_call(torch, 'zadd', sub),
                            TRUNK_INNER), bytes=nbytes, ops=ops)


def finish_oracle(torch, args):
    """finish_image, which upsample_finish replaced (after dense and the
    shuffle copy, that kernel's oracle), on the shuffled conv output of one
    of its calls (the plain product's: the same shape and range): its
    error against its plain version (bitwise: the same float32 operations
    and one float16 rounding), its device time, the plain version's, and
    its work. finish_image runs on no main path; no one PyTorch call
    computes it."""
    from lvae_tpu_torch.ops import trunk
    sub = (trunk._conv_shuffle_plain(*args),)
    _, err, worst, _, _ = compare_trunk_kernel(torch, 'finish_image', sub)
    require(err == 0.0, 'finish_image is not bitwise equal to its plain '
                        'version')
    nbytes, ops = work('finish_image', sub)
    return dict(
        max_abs_err=err,
        ms=graph_ms(torch, lambda: trunk.finish_image(*sub), TRUNK_INNER),
        plain_ms=graph_ms(torch,
                          lambda: trunk.PLAIN[trunk.finish_image](*sub),
                          TRUNK_PLAIN_INNER, repeats=3),
        library_ms=None, bytes=nbytes, ops=ops)


def off_path_per_image(shapes, key):
    """The rows of an off-path kernel (zadd_oracle's, `key` 'zadd';
    finish_oracle's, 'finish') at its main-path kernel's shapes over one
    image's calls: the times and work summed, the error's maximum, the
    bound."""
    calls = [r['encode_calls'] + r['decode_calls'] for r in shapes]
    out = {k: sum(r[key][k] * n for r, n in zip(shapes, calls))
           for k in ('ms', 'plain_ms', 'bytes', 'ops')}
    lib = [r[key]['library_ms'] for r in shapes]
    out['library_ms'] = (None if None in lib
                         else sum(v * n for v, n in zip(lib, calls)))
    bytes_ms = out['bytes'] / HBM_BYTES_PER_S * 1e3
    ops_ms = out['ops'] / SCALAR_OPS_PER_S * 1e3
    return dict(out, calls=sum(calls),
                max_abs_err=max(r[key]['max_abs_err'] for r in shapes),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by='bytes' if bytes_ms >= ops_ms else 'operations')


def check_trunk_kernels(torch, names, cases):
    """Each trunk kernel of `names` against its plain version on the card at
    every main-path shape, the B=1 vs B=2 bitwise check, and the times. The
    inputs are captured from one encode + decode of each (label, encode,
    decode) of `cases` (decode takes what encode returns); the per-image
    launch and time sums count the first case's calls, the others add the
    shapes it lacks. Library times (one PyTorch call computing the same
    function, TF32 off) are summed over the launches that have one. The
    redesigns' oracles are held against the plain version too
    (oracle_max_abs_err); zadd_conv_kxk's calls also check and time zadd
    on their (syms, pm) (zadd_oracle)."""
    from lvae_tpu_torch.ops import trunk

    label, encode, decode = cases[0]
    inputs, calls = capture_trunk_inputs(encode, decode, names)
    seen_in = {n: dict.fromkeys(inputs[n], label) for n in names}
    for label, encode, decode in cases[1:]:
        more, _ = capture_trunk_inputs(encode, decode, names)
        for name in names:
            for sig, args in more[name].items():
                if sig not in inputs[name]:
                    inputs[name][sig] = args
                    calls[name][sig] = [0, 0]
                    seen_in[name][sig] = label
    torch.backends.cuda.matmul.allow_tf32 = False   # exact plain products
    results = {}
    for name in names:
        fn = getattr(trunk, name)
        plain = trunk.PLAIN[fn]
        shapes = []
        for sig, args in inputs[name].items():
            n_enc, n_dec = calls[name][sig]
            got, err, worst, flips, flips_ok = compare_trunk_kernel(
                torch, name, args)
            # batch independence: the first image of a batch of two gets
            # the bits it gets alone
            args2 = second_image(torch, name, args)
            two = fn(*args2)
            two = two if isinstance(two, tuple) else (two,)
            batch_ok = all(torch.equal(t[:1], g) for t, g in zip(two, got))
            # the tiled core against the old one, at B = 1 and B = 2
            core_ok = (core_bitwise(torch, name, args, got)
                       and core_bitwise(torch, name, args2, two)
                       if name in CORE_NAMES else None)
            # the stencil pair against its warp-per-pixel kernel, likewise
            warp_ok = (warp_bitwise(torch, name, args, got[0])
                       and warp_bitwise(torch, name, args2, two[0])
                       if name in DW_NAMES else None)
            # the redesigns against the design they replaced, likewise
            oracle_ok = (oracle_bitwise(torch, name, args, got)
                         and oracle_bitwise(torch, name, args2, two)
                         if name in REDESIGN_ORACLES else None)
            # device times from CUDA-graph replays; the eager time (what
            # the codec pays, host launch time included) beside the
            # kernel's
            ms = graph_ms(torch, lambda: fn(*args), TRUNK_INNER)
            eager_ms = per_call_ms(torch, lambda: fn(*args), TRUNK_INNER)
            plain_ms = graph_ms(torch, lambda: plain(*args),
                                TRUNK_PLAIN_INNER, repeats=3)
            # the old core: the oracles' device time
            old_core_ms = (graph_ms(torch, lambda: core_oracle(
                torch, name, args), TRUNK_INNER)
                if name in OLD_CORE_TIMED else None)
            oracle_ms = oracle_err = None
            if name in REDESIGN_ORACLES:
                oracle_ms = graph_ms(torch, lambda: replaced_design(
                    torch, name, args), TRUNK_INNER)
                _, oracle_err, oracle_worst, _, _ = compare_trunk_kernel(
                    torch, name, args,
                    lambda *a: replaced_design(torch, name, a))
                require(oracle_worst <= 1.0, f'{name}\'s oracle disagrees '
                                             f'with the plain version')
            zadd = (zadd_oracle(torch, args) if name == 'zadd_conv_kxk'
                    else None)
            finish = (finish_oracle(torch, args) if name == 'upsample_finish'
                      else None)
            designs = design_times(torch, name, args)
            library_ms = warp_ms = two_calls_ms = None
            lib = library_call(torch, name, args)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                if lib is not None:
                    library_ms = graph_ms(torch, lib, TRUNK_INNER)
                if name in DW_NAMES:
                    two_calls_ms = graph_ms(torch, two_calls(torch, name,
                                                             args),
                                            TRUNK_INNER)
            if name in DW_NAMES:
                warp_ms = graph_ms(torch, lambda: warp_oracle(name)(*args),
                                   TRUNK_INNER)
            nbytes, ops = work(name, args)
            shapes.append(dict(
                shapes=[list(s[0]) if isinstance(s, tuple) else s
                        for s in sig],
                image=seen_in[name][sig], encode_calls=n_enc,
                decode_calls=n_dec, max_abs_err=err,
                err_over_tolerance=worst, index_flips=flips,
                flips_at_table_entries=flips_ok, batch_independent=batch_ok,
                core_bitwise=core_ok, warp_bitwise=warp_ok,
                oracle_bitwise=oracle_ok, ms=ms, eager_ms=eager_ms,
                old_core_ms=old_core_ms, oracle_ms=oracle_ms,
                oracle_max_abs_err=oracle_err, zadd=zadd, finish=finish,
                **{k: designs.get(k) for k in DESIGN_KEYS},
                warp_oracle_ms=warp_ms, plain_ms=plain_ms,
                library_ms=library_ms, two_calls_ms=two_calls_ms,
                bytes=nbytes, ops=ops,
                bound_ms=max(nbytes / HBM_BYTES_PER_S,
                             ops / SCALAR_OPS_PER_S) * 1e3))
            progress(f'{name} {shapes[-1]["shapes"][0]}: err {err:.2e} '
                     f'({worst:.2f} of tol) flips {flips} batch_ok '
                     f'{batch_ok} {ms * 1e3:.1f} us, eager '
                     f'{eager_ms * 1e3:.1f} us (plain {plain_ms * 1e3:.1f} '
                     f'us)')
        require(shapes, f'{name}: no call captured on its path')
        for r in shapes:
            what = f'{name} at {r["shapes"]}'
            require_trunk_match(f'{what} (max abs err '
                                f'{r["max_abs_err"]:.3g})',
                                r['err_over_tolerance'],
                                r['flips_at_table_entries'])
            require(r['batch_independent'],
                    f'{what}: batch of two changes the first image\'s bits')
            require(r['core_bitwise'] is not False,
                    f'{what}: not bitwise equal to the old product core')
            require(r['warp_bitwise'] is not False,
                    f'{what}: not bitwise equal to the warp-per-pixel kernel')
            require(r['oracle_bitwise'] is not False,
                    f'{what}: not bitwise equal to the design it replaced')

        def per_image(key, enc=1, dec=1, rows=shapes):
            """key summed over one image's launches (encode, decode)."""
            return sum(r[key] * (enc * r['encode_calls']
                                 + dec * r['decode_calls']) for r in rows)

        nbytes, ops = per_image('bytes'), per_image('ops')
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / SCALAR_OPS_PER_S * 1e3
        lib_rows = [r for r in shapes if r['library_ms'] is not None]
        staged_rows = [r for r in shapes if r['staged_gelu_ms'] is not None]
        results[name] = dict(
            ms=per_image('ms'), encode_ms=per_image('ms', dec=0),
            decode_ms=per_image('ms', enc=0), plain_ms=per_image('plain_ms'),
            eager_ms=per_image('eager_ms'),
            # the library's time and the kernel's over the same launches
            library_ms=per_image('library_ms', rows=lib_rows)
            if lib_rows else None,
            library_launches=sum(r['encode_calls'] + r['decode_calls']
                                 for r in lib_rows),
            kernel_ms_where_library=per_image('ms', rows=lib_rows)
            if lib_rows else None,
            **({'old_core_ms': per_image('old_core_ms')}
               if name in OLD_CORE_TIMED else {}),
            **({'product_ms': per_image('product_ms')}
               if name == 'prior_head' else {}),
            **({'staged_gelu_ms': per_image('staged_gelu_ms',
                                            rows=staged_rows),
                'kernel_ms_where_staged': per_image('ms', rows=staged_rows)}
               if staged_rows else {}),
            **{k: per_image(k) for k in ('prepass_ms', 'addmm_ms',
                                         'cluster8_ms', 'conv_alone_ms',
                                         'search_library_ms', 'oracle_ms')
               if all(r[k] is not None for r in shapes)},
            **({'oracle_bitwise_shapes': len(shapes),
                'oracle_max_abs_err': max(r['oracle_max_abs_err']
                                          for r in shapes)}
               if name in REDESIGN_ORACLES else {}),
            **({'zadd': off_path_per_image(shapes, 'zadd')}
               if name == 'zadd_conv_kxk' else {}),
            **({'finish_image': off_path_per_image(shapes, 'finish')}
               if name == 'upsample_finish' else {}),
            **({'core_bitwise_shapes': len(shapes)}
               if name in CORE_NAMES else {}),
            **({'warp_oracle_ms': per_image('warp_oracle_ms'),
                'two_calls_ms': per_image('two_calls_ms'),
                'warp_bitwise_shapes': len(shapes)}
               if name in DW_NAMES else {}),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by='bytes' if bytes_ms >= ops_ms else 'operations',
            max_abs_err=max(r['max_abs_err'] for r in shapes),
            err_over_tolerance=max(r['err_over_tolerance'] for r in shapes),
            index_flips=sum(r['index_flips'] for r in shapes),
            by_shape=shapes)
    return results


# ---- QRes-VAE (qres34m) ----------------------------------------------------

def build_qres34m(torch, name='qres34m'):
    """qres34m (or qres34m_lossless, qres17m) at full width on the card, its
    weights
    drawn as the JAX package's flax init draws them (lecun-normal kernels,
    zero biases) from a seeded generator; then each latent block's prior.c4
    re-drawn at the same scale: flax zero-initialises it, and with it the
    prior would give pm = 0 and one scale index everywhere, so that its
    check would prove nothing. No trained QRes checkpoint exists
    (bench.py:507-510)."""
    import lvae_tpu_torch
    from lvae_tpu_torch.models import common
    model = lvae_tpu_torch.get_model(name)
    g = torch.Generator().manual_seed(QRES_SEED)
    common.flax_init_(model.net, g)
    for blk in model.net.dec_blocks:
        if getattr(blk, 'is_latent_block', False):
            common.lecun_normal_(blk.prior.c4.weight, g)
    return model


def run_qres(torch, tmpdir):
    """The QRes-VAE phase (module docstring, 7). -> (result dict, {kernel:
    launches of the photo1 file's compress_file + decompress_file}, kernel
    check results, fresh-process case, path of the saved weights)."""
    from lvae_tpu_torch.utils import coding
    t = time.perf_counter()
    model = build_qres34m(torch)
    load_s = time.perf_counter() - t
    state = os.path.join(tmpdir, 'qres34m_state.pt')
    torch.save(model.net.state_dict(), state)
    progress(f'qres34m built ({model.num_params()} params) in '
             f'{load_s:.1f} s')
    u8 = np.stack([coding.read_png(p) for p in QRES_PHOTOS])
    ims = u8.astype(np.float32) / 255.0
    im = ims[:1]
    H, W = u8.shape[1:3]
    cfg = dict(num_lanes=QRES_LANES, esc_cap=QRES_ESC_CAP)
    model.compress_mode(portable=True, **cfg)

    # 1. the file path (portable), the launches of each call; compress ->
    # decompress, the file and compress_check's reconstruction, bitwise
    path = os.path.join(tmpdir, 'photo1.qres34m.bits')
    _, enc_l = counted_call(lambda: model.compress_file(QRES_PHOTOS[0],
                                                         path))
    rec, dec_l = counted_call(lambda: model.decompress_file(path))
    obj_chk, recon = model.compress_check(im)
    obj, c_enc_l = counted_call(lambda: model.compress(im))
    dec, c_dec_l = counted_call(lambda: model.decompress(obj))
    with open(path, 'rb') as f:
        file_body = pickle.loads(f.read())[0]
    bit_exact = bool(obj == obj_chk and file_body == obj[0]
                     and np.array_equal(dec, recon)
                     and np.array_equal(rec, recon))
    n_words, n_esc, lanes_field = struct.unpack('<IIH', obj[0][:10])
    psnr, bpp = psnr_bpp(rec, im, os.path.getsize(path))
    progress(f'qres34m photo1 portable: {bpp:.4f} bpp {psnr:.2f} dB, '
             f'{n_esc} escapes, {n_words} words, bit_exact={bit_exact}')

    # 2. the legacy trunk
    model.compress_mode(portable=False, **cfg)
    lobj, lrecon = model.compress_check(im)
    legacy_field = struct.unpack('<H', lobj[0][8:10])[0]
    legacy_ok = bool(np.array_equal(model.decompress(lobj), lrecon)
                     and legacy_field == QRES_LANES)

    # 3. a B = 2 request (photo1, photo2): the batch decode against
    # encode_check_batch, each batch stream alone, single streams as a batch
    model.compress_mode(portable=True, **cfg)
    objs, b_enc_l = counted_call(lambda: model.compress_batch(ims))
    bdec, b_dec_l = counted_call(lambda: model.decompress_batch(objs))
    ims_t = torch.as_tensor(ims, device=model.device).permute(0, 3, 1, 2)
    bodies, brecon = model._fused.encode_check_batch(ims_t.contiguous())
    batch_ok = bool([o[0] for o in objs] == bodies
                    and np.array_equal(bdec, brecon))
    alone_ok = all(bool(np.array_equal(model.decompress(o)[0], bdec[b]))
                   for b, o in enumerate(objs))
    singles = [obj, model.compress(ims[1:2])]
    singles_ok = bool(np.array_equal(
        model.decompress_batch(singles),
        np.concatenate([model.decompress(o) for o in singles])))

    # 4. every trunk kernel of the path (the six QRes kernels and the four
    # it shares with qarv) against its plain version at every shape of one
    # photo1 encode + decode, B = 1 against B = 2 (zadd_conv_kxk's calls
    # also check zadd); the trunk's device time
    kernels = check_trunk_kernels(torch, QRES_PATH_TRUNK, [
        ('photo1', lambda: model.compress(im), model.decompress)])
    trunk_ms = {d: sum(r[f'{d}_ms'] for r in kernels.values())
                for d in ('encode', 'decode')}
    # zadd_dense against the old core and upsample_finish against its chain
    # also at the B = 2 request's shapes
    held = hold_redesigns(torch, ('zadd_dense', 'upsample_finish'), [
        ('B = 2 request', lambda: model.compress_batch(ims),
         model.decompress_batch)])

    # 5. bench.py's qres34m workload (bench.py:511-539): enc_ms from a
    # device-resident image to the bytes on the host, dec_ms to the image
    # on the device, synchronised; median of 5 after a warm-up; both trunks
    im_dev = torch.as_tensor(im, device=model.device)
    times = {}
    for portable in (True, False):
        model.compress_mode(portable=portable, **cfg)
        enc_ms, o = _host_ms(torch, lambda: model.compress(im_dev), 5)
        _, fH, fW, _ = o[1]
        dec_ms, _ = _host_ms(torch, lambda: model.decompress_to_device(
            o[0], fH, fW), 5)
        times['portable' if portable else 'legacy'] = dict(
            enc_ms=enc_ms, dec_ms=dec_ms)
    model.compress_mode(portable=True, **cfg)
    progress(f'qres34m times: {times}')

    # 6. escapes: random posteriors at flax scale give none at this width,
    # so channel 0 of the last latent block's posterior is scaled x3000 (at
    # most one escape per pixel of its 128x192 grid, far under esc_cap);
    # the escape compaction and patch_escapes run on both trunks and in a
    # batch. Last, as it changes the weights (restored after)
    c4 = [b for b in model.net.dec_blocks
          if getattr(b, 'is_latent_block', False)][-1].posterior.c4
    kept = c4.weight.detach().clone()
    with torch.no_grad():
        c4.weight[0].mul_(3000.0)
    esc = {}
    for portable in (True, False):
        model.compress_mode(portable=portable, **cfg)
        eobj, erecon = model.compress_check(im)
        esc['portable' if portable else 'legacy'] = dict(
            escapes=struct.unpack('<IIH', eobj[0][:10])[1],
            bit_exact=bool(np.array_equal(model.decompress(eobj), erecon)))
    model.compress_mode(portable=True, **cfg)
    eobjs = model.compress_batch(ims)
    ebodies, ebrecon = model._fused.encode_check_batch(ims_t.contiguous())
    ebdec = model.decompress_batch(eobjs)
    esc['batch'] = dict(
        escapes=[struct.unpack('<IIH', o[0][:10])[1] for o in eobjs],
        bit_exact=bool([o[0] for o in eobjs] == ebodies
                       and np.array_equal(ebdec, ebrecon)
                       and all(np.array_equal(model.decompress(o)[0],
                                              ebdec[b])
                               for b, o in enumerate(eobjs))))
    with torch.no_grad():
        c4.weight.copy_(kept)
    progress(f'qres34m with escapes: {esc}')

    want_enc, want_dec = EXPECTED_QRES_LAUNCHES
    want_benc = dict(want_enc, rans_encode_all=0, rans_encode_all_multi=1)
    want_bdec = dict(want_dec, rans_decode_block=0,
                     rans_decode_block_multi=want_dec['rans_decode_block'])
    result = dict(
        model='qres34m',
        weights=f'random, flax-style init, seed {QRES_SEED}, prior.c4 '
                'redrawn', params=model.num_params(), load_s=load_s,
        image=os.path.relpath(QRES_PHOTOS[0], ROOT), lanes=QRES_LANES,
        esc_cap=QRES_ESC_CAP, portable_marker=bool(lanes_field & 0x8000),
        bytes=os.path.getsize(path), bpp=bpp, psnr=psnr, escapes=n_esc,
        n_words=n_words, finite=bool(np.isfinite(rec).all()),
        shape=list(rec.shape), bit_exact=bit_exact,
        legacy_bit_exact=legacy_ok, batch_images=[
            os.path.relpath(p, ROOT) for p in QRES_PHOTOS],
        batch_bit_exact=batch_ok, batch_stream_alone_bitwise=alone_ok,
        single_streams_as_batch_bitwise=singles_ok,
        file_encode_launches=enc_l, file_decode_launches=dec_l,
        compress_launches=c_enc_l, decompress_launches=c_dec_l,
        batch_encode_launches=b_enc_l, batch_decode_launches=b_dec_l,
        times=times, trunk_device_ms=trunk_ms, scaled_posterior=esc,
        redesigns_held=held,
        **rans_share(torch, lambda: model.decompress(obj),
                     times['portable']['dec_ms']))
    require(result['finite'] and rec.shape == (1, H, W, 3),
            'qres34m: bad reconstruction')
    require(result['portable_marker'], 'qres34m: file without the marker')
    require(bit_exact, 'qres34m: portable decode is not bit-exact')
    require(legacy_ok, 'qres34m: legacy decode is not bit-exact')
    require(batch_ok, 'qres34m: batch decode is not bit-exact')
    require(alone_ok, 'qres34m: a batch stream decoded alone differs')
    require(singles_ok, 'qres34m: single streams decoded as a batch differ')
    for what, r in esc.items():
        require(r['bit_exact'], f'qres34m {what} with escapes: not bit-exact')
        require(min(np.atleast_1d(r['escapes'])) > 0,
                f'qres34m {what}: the scaled posterior gave no escape')
    for got, want, what in ((enc_l, want_enc, 'compress_file'),
                            (dec_l, want_dec, 'decompress_file'),
                            (c_enc_l, want_enc, 'compress'),
                            (c_dec_l, want_dec, 'decompress'),
                            (b_enc_l, want_benc, 'compress_batch'),
                            (b_dec_l, want_bdec, 'decompress_batch')):
        require(got == want, f'qres34m {what}: launches {got}, expected '
                             f'{want}')
    launches = {n: enc_l[n] + dec_l[n] for n in enc_l}
    return (result, launches, kernels,
            ('qres34m photo1 file', 'qres', path, recon), state)


# ---- the lossless pixel head (qres34m_lossless) ---------------------------

def record_calls(module, name, out):
    """Replace module.name by a wrapper that appends each call's cloned
    positional arguments, its keyword arguments and its result to `out`;
    -> a function that restores it. The wrapper carries `.launches`, which
    the kernel wrapper counts through its module-level name."""
    fn = getattr(module, name)

    def call(*args, **kwargs):
        kept = tuple(a.detach().clone() if hasattr(a, 'clone') else a
                     for a in args)
        res = fn(*args, **kwargs)
        out.append((kept, kwargs, res))
        return res
    call.launches = 0
    setattr(module, name, call)
    return lambda: setattr(module, name, fn)


def nll_synthetic(torch, shape, device):
    """photo1-sized inputs of nll_head and nll_recon: means on the pixel
    grid's half-points moved by up to 3 ulps (a fifth random in [-3, 3]),
    raw scales on the head table's entries moved by up to 4 ulps (a tenth
    random in [-12, 3]), symbols in [-300, 300]."""
    from lvae_tpu_torch.ops import cdf
    rng = np.random.default_rng(QRES_SEED)
    n = int(np.prod(shape))
    table = cdf.lossless_head_scale_table().astype(np.float32)
    m = ((rng.integers(-3, 259, n) + 0.5) / 127.5 - 1).astype(np.float32)
    r = (np.log(table[rng.integers(0, 128, n)].astype(np.float64))
         + math.log(1 / 127.5)).astype(np.float32)
    for x, k in ((m, 3), (r, 4)):
        x += rng.integers(-k, k + 1, n) * np.spacing(x)
    wild = rng.random(n) < 0.2
    m[wild] = rng.uniform(-3, 3, int(wild.sum()))
    wild &= rng.random(n) < 0.5
    r[wild] = rng.uniform(-12, 3, int(wild.sum()))
    syms = rng.integers(-300, 301, n).astype(np.int32)
    return [torch.as_tensor(a.reshape(shape), device=device)
            for a in (m, r, syms)] + [torch.as_tensor(table, device=device)]


def check_nll_synthetic(torch, H, W, device):
    """nll_head and nll_recon bitwise against their plain versions on the
    synthetic inputs at (1, H, W, 3) and (2, H, W, 3), nll_head also
    against nll_head_linear, the first image of the batch bitwise as alone;
    -> summary."""
    from lvae_tpu_torch.ops import trunk
    both = nll_synthetic(torch, (2, H, W, 3), device)
    out, alone = {}, None
    for B in (1, 2):
        m, r, syms = (a[:B].contiguous() for a in both[:3])
        table = both[3]
        pm, idx = trunk.nll_head(m, r, table, 1 / 127.5)
        want_pm, want_idx = trunk.nll_head_plain(m, r, table, 1 / 127.5)
        linear = trunk.nll_head_linear(m, r, table, 1 / 127.5)
        rec = trunk.nll_recon(syms, pm, 1 / 127.5)
        want_rec = trunk.nll_recon_plain(syms, pm, 1 / 127.5)
        out[f'B{B}'] = dict(
            pm_bitwise=bool(torch.equal(pm, want_pm)),
            index_flips=int((idx != want_idx).sum()),
            linear_bitwise=all(same_bits(torch, a, b)
                               for a, b in zip((pm, idx), linear)),
            recon_bitwise=bool(torch.equal(rec, want_rec)),
            distinct_indexes=int(idx.unique().numel()),
            pixels_min_max=[float(rec.min()), float(rec.max())])
        if alone is None:
            alone = (pm, idx, rec)
        else:
            out['B2_image0_as_alone'] = all(
                torch.equal(a[:1], b) for a, b in zip((pm, idx, rec), alone))
    progress(f'nll kernels on synthetic {H}x{W} inputs: {out}')
    for B in ('B1', 'B2'):
        o = out[B]
        require(o['pm_bitwise'] and o['index_flips'] == 0
                and o['recon_bitwise'] and o['linear_bitwise'],
                f'nll kernels at {B} {H}x{W}: not bitwise equal to their '
                f'plain versions ({o})')
        require(o['distinct_indexes'] == 128,
                'synthetic nll inputs do not cover the head table')
    require(out['B2_image0_as_alone'], 'nll kernels: a batch of two '
                                       'changes the first image\'s bits')
    return out


def rans_block_times(torch, decode):
    """Run decode() with rd.rans_decode_block recorded, then time each
    recorded launch again (CUDA events, median of 5): -> ([ms of each
    launch], [rows of each launch]); the lossless head's block is the
    last."""
    from lvae_tpu_torch.ops import rans_decode as rd
    calls = []
    restore = record_calls(rd, 'rans_decode_block', calls)
    try:
        decode()
    finally:
        restore()
    ms = [cuda_ms(torch, lambda a=args, k=kw: rd.rans_decode_block(*a, **k),
                  KERNEL_REPEATS) for args, kw, _ in calls]
    return ms, [int(args[0].shape[0]) for args, _, _ in calls]


def rans_share(torch, decode, dec_ms):
    """The rANS decode launches of decode() (rans_block_times): their ms
    summed, rows, ns a row, and their share of `dec_ms`."""
    ms, rows = rans_block_times(torch, decode)
    return dict(rans_decode_ms=sum(ms), rans_decode_rows=sum(rows),
                rans_ns_per_row=sum(ms) * 1e6 / sum(rows),
                rans_share_of_dec_ms=sum(ms) / dec_ms)


def spread_head_scales(torch, model, crop):
    """Re-draw conv_scale of the head so that its scales spread over the
    table: its raw outputs on `crop` at the current weights, measured, are
    rescaled to unit spread per channel and shifted by a per-channel bias
    drawn in [-7, -2] (the log-scales of table entries 0.11 .. 20 in bin
    units lie in [-7.06, -1.85]). -> the old (weight, bias) to restore."""
    from lvae_tpu_torch.ops import trunk
    calls = []
    restore = record_calls(trunk, 'nll_head', calls)
    try:
        model.compress(crop)
    finally:
        restore()
    raw = calls[0][0][1].reshape(-1, 3)                     # (pixels, 3)
    conv = model.net.out_net.conv_scale.conv
    kept = conv.weight.detach().clone(), conv.bias.detach().clone()
    g = torch.Generator().manual_seed(QRES_SEED)
    # conv channel c*16 + (di*4 + dj) feeds pixel channel c (pixel shuffle)
    std = raw.std(0).repeat_interleave(16)
    with torch.no_grad():
        conv.weight.div_(std.reshape(-1, 1, 1, 1).clamp(min=1e-12))
        conv.bias.copy_(torch.empty(conv.bias.shape).uniform_(
            -7.0, -2.0, generator=g))
    return kept


def run_lossless(torch, tmpdir):
    """The lossless phase (module docstring, 8). -> (result dict, {kernel:
    launches of the photo1 file's compress_file + decompress_file}, kernel
    check results, fresh-process case, path of the saved weights)."""
    from lvae_tpu_torch.ops import trunk
    from lvae_tpu_torch.utils import coding
    t = time.perf_counter()
    model = build_qres34m(torch, 'qres34m_lossless')
    load_s = time.perf_counter() - t
    state = os.path.join(tmpdir, 'qres34m_lossless_state.pt')
    torch.save(model.net.state_dict(), state)
    progress(f'qres34m_lossless built ({model.num_params()} params) in '
             f'{load_s:.1f} s')
    u8 = np.stack([coding.read_png(p) for p in QRES_PHOTOS])
    ims = u8.astype(np.float32) / 255.0
    im = ims[:1]
    cfg = dict(num_lanes=QRES_LANES, esc_cap=LOSSLESS_ESC_CAP)
    model.compress_mode(portable=True, **cfg)

    # 1. the file path (portable): the PNG's pixels back exactly; compress
    # -> decompress and compress_check's reconstruction, bitwise
    path = os.path.join(tmpdir, 'photo1.qres34m_lossless.bits')
    _, enc_l = counted_call(lambda: model.compress_file(QRES_PHOTOS[0],
                                                         path))
    rec, dec_l = counted_call(lambda: model.decompress_file(path))
    obj_chk, recon = model.compress_check(im)
    obj, c_enc_l = counted_call(lambda: model.compress(im))
    dec, c_dec_l = counted_call(lambda: model.decompress(obj))
    with open(path, 'rb') as f:
        file_body = pickle.loads(f.read())[0]
    exact = bool(np.array_equal(rec, im))
    bit_exact = bool(obj == obj_chk and file_body == obj[0]
                     and np.array_equal(dec, recon)
                     and np.array_equal(recon, im))
    n_words, n_esc, lanes_field = struct.unpack('<IIH', obj[0][:10])
    bpp = os.path.getsize(path) * 8 / (im.shape[1] * im.shape[2])
    progress(f'qres34m_lossless photo1 portable: {bpp:.4f} bpp, {n_esc} '
             f'escapes, {n_words} words, exact={exact} '
             f'bit_exact={bit_exact}')

    # 2. the legacy trunk
    model.compress_mode(portable=False, **cfg)
    lobj, lrecon = model.compress_check(im)
    legacy_ok = bool(np.array_equal(model.decompress(lobj), im)
                     and np.array_equal(lrecon, im)
                     and struct.unpack('<H', lobj[0][8:10])[0] == QRES_LANES)

    # 3. a B = 2 request (photo1, photo2), as in the qres phase
    model.compress_mode(portable=True, **cfg)
    objs, b_enc_l = counted_call(lambda: model.compress_batch(ims))
    bdec, b_dec_l = counted_call(lambda: model.decompress_batch(objs))
    ims_t = torch.as_tensor(ims, device=model.device).permute(0, 3, 1, 2)
    bodies, brecon = model._fused.encode_check_batch(ims_t.contiguous())
    batch_ok = bool([o[0] for o in objs] == bodies
                    and np.array_equal(bdec, brecon)
                    and np.array_equal(bdec, ims))
    alone_ok = all(bool(np.array_equal(model.decompress(o)[0], ims[b]))
                   for b, o in enumerate(objs))
    singles = [obj, model.compress(ims[1:2])]
    singles_ok = bool(np.array_equal(model.decompress_batch(singles), ims))

    # 4. the head's kernels at every shape of one photo1 encode + decode
    # (nll_head, nll_recon bitwise; upsample_head bitwise against its
    # chain; the trunk's dense, mlp_res, dense_act, prior_head and
    # res_dense_act as in the qres phase) and on photo1-sized synthetic
    # inputs
    kernels = check_trunk_kernels(torch, LOSSLESS_HEAD + (
        'dense', 'mlp_res', 'dense_act', 'prior_head', 'res_dense_act',
        'zadd_dense'), [
        ('photo1', lambda: model.compress(im), model.decompress)])
    for name in LOSSLESS_TRUNK:
        require_bitwise(name, kernels[name]['by_shape'])
    synthetic = check_nll_synthetic(torch, *im.shape[1:3], model.device)
    # nll_head, zadd_dense and upsample_head against their oracles also at
    # the B = 2 request's shapes (the spread crop's below)
    held = hold_redesigns(torch, ('zadd_dense', 'nll_head',
                                  'upsample_head'), [
        ('B = 2 request', lambda: model.compress_batch(ims),
         model.decompress_batch)])

    # 5. the head block's rANS decode apart from the latent blocks'; then
    # bench.py's qres34m workload on both trunks, as in the qres phase
    block_ms, block_rows = rans_block_times(
        torch, lambda: model.decompress(obj))
    latent_ms, head_ms, head_rows = (sum(block_ms[:-1]), block_ms[-1],
                                     block_rows[-1])
    progress(f'rANS decode: latent blocks {latent_ms:.3f} ms, the head '
             f'block {head_ms:.3f} ms ({head_rows} rows)')
    im_dev = torch.as_tensor(im, device=model.device)
    times = {}
    for portable in (True, False):
        model.compress_mode(portable=portable, **cfg)
        enc_ms, o = _host_ms(torch, lambda: model.compress(im_dev), 5)
        _, fH, fW, _ = o[1]
        dec_ms, _ = _host_ms(torch, lambda: model.decompress_to_device(
            o[0], fH, fW), 5)
        # the decode's host share: parsing the body and pushing it
        push_ms, _ = _host_ms(torch, lambda: model._fused._push([o[0]]), 5)
        times['portable' if portable else 'legacy'] = dict(
            enc_ms=enc_ms, dec_ms=dec_ms, parse_push_ms=push_ms)
    model.compress_mode(portable=True, **cfg)
    progress(f'qres34m_lossless times: {times}')

    # 6. spread head scales on a crop (restored after): escapes, and the
    # head's index math across its table, on both trunks
    crop = np.ascontiguousarray(im[:, :SPREAD_CROP, :SPREAD_CROP])
    kept = spread_head_scales(torch, model, crop)
    spread = {}
    for portable in (True, False):
        model.compress_mode(portable=portable, **cfg)
        heads = []
        restore = record_calls(trunk, 'nll_head', heads) if portable else (
            lambda: None)
        try:
            sobj, srecon = model.compress_check(crop)
        finally:
            restore()
        sdec = model.decompress(sobj)
        spread['portable' if portable else 'legacy'] = dict(
            escapes=struct.unpack('<IIH', sobj[0][:10])[1],
            bytes=len(sobj[0]),
            exact=bool(np.array_equal(sdec, crop)
                       and np.array_equal(srecon, crop)),
            **({'distinct_head_indexes': int(heads[0][2][1].unique().numel())}
               if portable else {}))
    model.compress_mode(portable=True, **cfg)
    for name, by_label in hold_redesigns(torch, (
            'zadd_dense', 'nll_head', 'upsample_head'), [
            ('spread crop', lambda: model.compress(crop),
             model.decompress)]).items():
        held[name].update(by_label)
    conv = model.net.out_net.conv_scale.conv
    with torch.no_grad():
        conv.weight.copy_(kept[0])
        conv.bias.copy_(kept[1])
    model.compress_mode(portable=True, **cfg)
    progress(f'qres34m_lossless spread scales on a {SPREAD_CROP}x'
             f'{SPREAD_CROP} crop: {spread}')

    want_enc, want_dec = EXPECTED_LOSSLESS_LAUNCHES
    want_benc = dict(want_enc, rans_encode_all=0, rans_encode_all_multi=1)
    want_bdec = dict(want_dec, rans_decode_block=0,
                     rans_decode_block_multi=want_dec['rans_decode_block'])
    result = dict(
        model='qres34m_lossless',
        weights=f'random, flax-style init, seed {QRES_SEED}, prior.c4 '
                'redrawn', params=model.num_params(), load_s=load_s,
        image=os.path.relpath(QRES_PHOTOS[0], ROOT), lanes=QRES_LANES,
        esc_cap=LOSSLESS_ESC_CAP, portable_marker=bool(lanes_field & 0x8000),
        bytes=os.path.getsize(path), bpp=bpp, escapes=n_esc,
        n_words=n_words, file_pixels_exact=exact, bit_exact=bit_exact,
        legacy_exact=legacy_ok,
        batch_images=[os.path.relpath(p, ROOT) for p in QRES_PHOTOS],
        batch_exact=batch_ok, batch_stream_alone_exact=alone_ok,
        single_streams_as_batch_exact=singles_ok,
        file_encode_launches=enc_l, file_decode_launches=dec_l,
        compress_launches=c_enc_l, decompress_launches=c_dec_l,
        batch_encode_launches=b_enc_l, batch_decode_launches=b_dec_l,
        nll_synthetic=synthetic, rans_decode_latent_ms=latent_ms,
        rans_decode_head_ms=head_ms, head_rows=head_rows,
        head_ns_per_row=head_ms * 1e6 / head_rows,
        rans_share_of_dec_ms=(latent_ms + head_ms)
        / times['portable']['dec_ms'], times=times,
        # the head's kernels (mlp_res is the qres34m trunk's)
        trunk_device_ms={d: sum(kernels[n][f'{d}_ms']
                                for n in LOSSLESS_HEAD)
                         for d in ('encode', 'decode')},
        spread_crop=SPREAD_CROP, spread=spread, redesigns_held=held)
    require(result['portable_marker'], 'qres34m_lossless: file without the '
                                       'marker')
    require(exact, 'qres34m_lossless: the file does not give the PNG\'s '
                   'pixels back')
    require(bit_exact, 'qres34m_lossless: portable round trip not exact')
    require(legacy_ok, 'qres34m_lossless: legacy round trip not exact')
    require(batch_ok, 'qres34m_lossless: batch round trip not exact')
    require(alone_ok, 'qres34m_lossless: a batch stream decoded alone '
                      'differs')
    require(singles_ok, 'qres34m_lossless: single streams decoded as a '
                        'batch differ')
    for what, r in spread.items():
        require(r['exact'], f'qres34m_lossless spread {what}: not exact')
        require(r['escapes'] > 0, f'qres34m_lossless spread {what}: no '
                                  f'escape')
    require(spread['portable']['distinct_head_indexes'] >= MIN_HEAD_INDEXES,
            'qres34m_lossless spread: too few distinct head indexes')
    for got, want, what in ((enc_l, want_enc, 'compress_file'),
                            (dec_l, want_dec, 'decompress_file'),
                            (c_enc_l, want_enc, 'compress'),
                            (c_dec_l, want_dec, 'decompress'),
                            (b_enc_l, want_benc, 'compress_batch'),
                            (b_dec_l, want_bdec, 'decompress_batch')):
        require(got == want, f'qres34m_lossless {what}: launches {got}, '
                             f'expected {want}')
    launches = {n: enc_l[n] + dec_l[n] for n in enc_l}
    return (result, launches, kernels,
            ('qres34m_lossless photo1 file', 'lossless', path, im), state)


_FRESH_DECODE = r'''
import json
import sys
import numpy as np
import torch
# what a decoding process may have set: none of it may change a portable
# stream's pixels
torch.backends.cudnn.allow_tf32 = True
torch.backends.cuda.matmul.allow_tf32 = True
torch.backends.cudnn.benchmark = True
import lvae_tpu_torch
spec = json.loads(sys.argv[1])
models = {}
if any(kind == 'qarv' for kind, _ in spec['files']):
    models['qarv'] = lvae_tpu_torch.get_model('qarv_base',
                                              pretrained=spec['checkpoint'])
    models['qarv'].compress_mode(num_lanes='auto', portable=True)
for kind, name in (('qres', 'qres34m'), ('lossless', 'qres34m_lossless')):
    if any(k == kind for k, _ in spec['files']):
        # random weights: the writing process saved them
        models[kind] = lvae_tpu_torch.get_model(name)
        models[kind].net.load_state_dict(torch.load(
            spec['states'][kind], map_location='cuda', weights_only=True))
        models[kind].compress_mode(num_lanes=spec['qres_lanes'],
                                   portable=True,
                                   esc_cap=spec['esc_caps'][kind])
np.savez(spec['out'], *[models[kind].decompress_file(path)
                        for kind, path in spec['files']])
assert torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.benchmark
assert torch.backends.cuda.matmul.allow_tf32
print('decoded in a fresh process')
'''


def fresh_process_decode(cases, tmpdir, states):
    """Decode portable files in a new python3 process with TF32 and
    cudnn.benchmark on; each file's pixels must equal the ones this process
    holds for it bitwise. cases: [(label, model kind 'qarv', 'qres' or
    'lossless', path, pixels)]; states: {kind: saved weights} of the
    randomly initialised models."""
    out = os.path.join(tmpdir, 'fresh.npz')
    spec = dict(checkpoint=CHECKPOINT, states=states,
                esc_caps=dict(qres=QRES_ESC_CAP, lossless=LOSSLESS_ESC_CAP),
                qres_lanes=QRES_LANES, out=out,
                files=[(kind, path) for _, kind, path, _ in cases])
    t = time.perf_counter()
    res = subprocess.run(
        [sys.executable, '-c', _FRESH_DECODE, json.dumps(spec)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600)
    seconds = time.perf_counter() - t
    require(res.returncode == 0,
            f'fresh-process decode failed:\n{res.stderr[-3000:]}')
    got = np.load(out)
    files = []
    for i, (label, _, _, want) in enumerate(cases):
        same = bool(np.array_equal(got[f'arr_{i}'], want))
        progress(f'fresh-process decode of {label}: bitwise equal {same}')
        require(same, f'{label} decoded in a fresh process (TF32 and '
                      f'cudnn.benchmark on) gives other pixels')
        files.append(dict(file=label, bitwise_equal=same))
    return dict(files=files, seconds=seconds,
                flags='cudnn.allow_tf32, cuda.matmul.allow_tf32, '
                      'cudnn.benchmark all True')


EVAL_STEPS = 6                      # the JAX package's sweep (SWEEP)
EVAL_LMB_RANGE = (16.0, 2048.0)
FORWARD_LMBS = (16.0, 2048.0)
FORWARD_BPP_RTOL, FORWARD_PSNR_DB = 1e-3, 0.01


def require_file_launches(what, launches, expected, n_images):
    """A file sweep (compress_file + decompress_file of each image) must
    launch every kernel n_images times its per-image (encode, decode)
    counts, whatever the images' shapes."""
    want = {n: n_images * (expected[0][n] + expected[1][n]) for n in _NONE}
    require(launches == want, f'{what}: launches {launches}, expected '
                              f'{want}')
    require(any(v for n, v in want.items() if n in TRUNK_NAMES),
            f'{what}: no trunk kernel expected')


def write_png(path, arr):
    """An 8-bit RGB PNG of an (H, W, 3) uint8 array, rows unfiltered (the
    card's machine has no image library)."""
    h, w, _ = arr.shape
    raw = b''.join(b'\x00' + arr[r].tobytes() for r in range(h))

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n'
                + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
                + chunk(b'IDAT', zlib.compress(raw)) + chunk(b'IEND', b''))


def run_eval(torch, model, tmpdir):
    """The eval phase (module docstring, 10) -> its result dict."""
    import lvae_tpu_torch
    from lvae_tpu_torch import evaluation
    from lvae_tpu_torch.utils import coding
    t0 = time.perf_counter()
    out = {}
    photos = os.path.join(tmpdir, 'realphotos')
    cwd = os.path.join(tmpdir, 'eval_cwd')
    os.makedirs(photos)
    os.makedirs(cwd)
    for path in PHOTOS:
        shutil.copy(path, photos)

    # 1. the CLI's sweep against the JAX package's (SWEEP)
    t = time.perf_counter()
    res = subprocess.run(
        [sys.executable, '-m', 'lvae_tpu_torch.eval_var_rate', '-m',
         'qarv_base', '-w', CHECKPOINT, '-n', photos, '-s', str(EVAL_STEPS)],
        cwd=cwd, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=900)
    cli_s = time.perf_counter() - t
    require(res.returncode == 0, f'eval_var_rate failed:\n'
                                 f'{res.stderr[-3000:]}')
    with open(os.path.join(cwd, 'runs', 'results',
                           'realphotos-qarv_base.json')) as f:
        got = json.load(f)
    with open(SWEEP) as f:
        want = json.load(f)
    require(list(got) == ['name', 'test-set', 'platform', 'device',
                          'lambdas', 'results'],
            f'eval_var_rate wrote the keys {list(got)}')
    lambdas_equal = got['lambdas'] == want['lambdas']
    require(np.allclose(got['lambdas'], want['lambdas'], rtol=1e-12, atol=0),
            f'sweep lambdas {got["lambdas"]} against {want["lambdas"]}')
    rows = []
    for i, lmb in enumerate(want['lambdas']):
        bpp, psnr = got['results']['bpp'][i], got['results']['psnr'][i]
        ref_bpp, ref_psnr = (want['results']['bpp'][i],
                             want['results']['psnr'][i])
        rows.append(dict(lmb=lmb, bpp=bpp, psnr=psnr, tpu_bpp=ref_bpp,
                         tpu_psnr=ref_psnr, bpp_rel=bpp / ref_bpp - 1,
                         psnr_db=psnr - ref_psnr))
        progress(f'sweep lambda {lmb:.2f}: {bpp:.4f} bpp / {psnr:.3f} dB, '
                 f'TPU {ref_bpp:.4f} / {ref_psnr:.3f}')
    for r in rows:
        require(abs(r['bpp_rel']) <= BPP_REL_TOL
                and abs(r['psnr_db']) <= PSNR_TOL_DB,
                f'sweep at lambda {r["lmb"]:.2f}: {r["bpp"]:.4f} bpp / '
                f'{r["psnr"]:.3f} dB against the TPU\'s {r["tpu_bpp"]:.4f} / '
                f'{r["tpu_psnr"]:.3f}')
    rd = coding.RDList()
    rd.add_json(SWEEP, label='tpu')
    rd.add_data(bpp=got['results']['bpp'], psnr=got['results']['psnr'],
                label='card')
    rd.set_bdrate_anchor('tpu')
    with contextlib.redirect_stdout(sys.stderr):       # stdout: JSON lines
        bd = rd.compute_bdrate()['card']
    out['sweep'] = dict(cli_s=cli_s, device=got['device'],
                        lambdas_equal=lambdas_equal, rows=rows,
                        bd_rate_vs_tpu_pct=bd,
                        bounds=f'bpp {BPP_REL_TOL:.0%}, PSNR {PSNR_TOL_DB} dB')

    # 2. the last lambda again in this process, its launches counted
    model.compress_mode()
    model.default_lmb = got['lambdas'][-1]
    stats, launches = counted_call(
        lambda: evaluation.imcoding_evaluate(model, photos, progress=False))
    require_file_launches('the qarv_base sweep', launches,
                          EXPECTED_LAUNCHES[True], len(PHOTOS))
    same = (stats['bpp'] == got['results']['bpp'][-1]
            and stats['psnr'] == got['results']['psnr'][-1])
    require(same, f'imcoding_evaluate here {stats} differs from the CLI\'s')
    out['in_process'] = dict(lmb=model.default_lmb, stats=stats,
                             equal_to_cli=same, launches={
                                 n: v for n, v in launches.items() if v})

    # 3. the forward: self_evaluate's estimates beside the files', and the
    # card against the CPU on photo1
    t = time.perf_counter()
    est = model.self_evaluate(photos, lmb_range=EVAL_LMB_RANGE,
                              steps=EVAL_STEPS)
    self_s = time.perf_counter() - t
    overhead = [dict(lmb=lmb, file_bpp=fb, estimated_bpp=eb,
                     file_over_estimate=fb - eb, estimated_psnr=ep,
                     file_psnr=fp)
                for lmb, fb, eb, ep, fp in zip(
                    est['lambda'], got['results']['bpp'], est['bpp'],
                    est['psnr'], got['results']['psnr'])]
    for r in overhead:
        progress(f'lambda {r["lmb"]:.2f}: file {r["file_bpp"]:.4f} bpp, '
                 f'estimated {r["estimated_bpp"]:.4f}')
    cpu = lvae_tpu_torch.get_model('qarv_base', pretrained=CHECKPOINT,
                                   device='cpu')
    im = coding.read_png(PHOTO).astype(np.float32)[None] / 255.0
    gaps = []
    for lmb in FORWARD_LMBS:
        t = time.perf_counter()
        g, c = model.forward(im, lmb=lmb), cpu.forward(im, lmb=lmb)
        bpp_gap = abs(g['bppix'] / c['bppix'] - 1)
        psnr_gap = abs(g['psnr'] - c['psnr'])
        gaps.append(dict(lmb=lmb, card=g, cpu=c, bpp_rel_gap=bpp_gap,
                         psnr_gap_db=psnr_gap,
                         seconds=time.perf_counter() - t))
        progress(f'forward at lambda {lmb:g}: card {g["bppix"]:.6f} bpp / '
                 f'{g["psnr"]:.4f} dB, CPU {c["bppix"]:.6f} / '
                 f'{c["psnr"]:.4f}')
        require(bpp_gap <= FORWARD_BPP_RTOL and psnr_gap <= FORWARD_PSNR_DB,
                f'forward at lambda {lmb:g}: card {g} against CPU {c}')
    del cpu
    out['forward'] = dict(self_evaluate=overhead, self_evaluate_s=self_s,
                          card_vs_cpu=gaps, bounds=f'bpp rtol '
                          f'{FORWARD_BPP_RTOL:g}, PSNR {FORWARD_PSNR_DB} dB')

    # 4. QRes-VAE: the file sweep with two shape buckets on photo1 and its
    # crop, and the forward on the card against the CPU
    qset = os.path.join(tmpdir, 'qres_set')
    os.makedirs(qset)
    shutil.copy(PHOTO, qset)
    write_png(os.path.join(qset, 'crop256.png'), np.ascontiguousarray(
        coding.read_png(PHOTO)[:SPREAD_CROP, :SPREAD_CROP]))
    out['qres'] = {}
    for name, esc_cap, expected in (
            ('qres34m', QRES_ESC_CAP, EXPECTED_QRES_LAUNCHES),
            ('qres34m_lossless', LOSSLESS_ESC_CAP,
             EXPECTED_LOSSLESS_LAUNCHES)):
        qm = build_qres34m(torch, name)
        qm.compress_mode(num_lanes=QRES_LANES, esc_cap=esc_cap)
        stats, launches = counted_call(lambda: evaluation.imcoding_evaluate(
            qm, qset, progress=False, shape_buckets=2))
        require_file_launches(f'the {name} sweep', launches, expected, 2)
        if qm.lossless:
            require(stats['mse'] == 0.0, f'{name}: the files are not '
                                         f'lossless: {stats}')
        else:
            require(stats['bpp'] > 0 and math.isfinite(stats['psnr']),
                    f'{name}: {stats}')
        cpu = lvae_tpu_torch.get_model(name, device='cpu')
        cpu.net.load_state_dict(qm.net.state_dict())
        g, c = (evaluation.image_self_evaluate(m, qset, progress=False)
                for m in (qm, cpu))
        bpp_gap = abs(g['bppix'] / c['bppix'] - 1)
        psnr_gap = abs(g['psnr'] - c['psnr'])
        progress(f'{name}: files {stats}; forward card {g}, CPU {c}')
        require(bpp_gap <= FORWARD_BPP_RTOL and psnr_gap <= FORWARD_PSNR_DB,
                f'{name} image_self_evaluate: card {g} against CPU {c}')
        out['qres'][name] = dict(
            files=stats, launches={n: v for n, v in launches.items() if v},
            forward_card=g, forward_cpu=c, bpp_rel_gap=bpp_gap,
            psnr_gap_db=psnr_gap)
        del qm, cpu
    out['images'] = dict(sweep=[os.path.relpath(p, ROOT) for p in PHOTOS],
                         qres=['photo1_512x768.png', 'its 256x256 crop'])
    out['seconds'] = time.perf_counter() - t0
    progress(f'eval phase: {out["seconds"]:.1f} s')
    return out


# ---- the staged coders (coder='host' and coder='device') and qres17m ------

STAGED_LMB = 2048.0           # qarv_base photo1: the main lambda's N = 128
STAGED_BPP_REL_TOL = 0.02     # host bpp against the legacy fused stream's
STAGED_REPEATS = 3
QRES17M_PHOTOS = PHOTOS[:2]   # B = 1 (photo1) and the B = 2 request


def rans_path_row(torch, name, run):
    """The launches of the rANS wrapper `name` in run(), recorded and each
    timed again (CUDA events, median of KERNEL_REPEATS) -> dict(launches,
    ms (their sum), rows, bound_ms, bound_by): the bound by the rule of
    check_kernels over those launches' inputs (indexes, symbols, the words
    the decode consumes or the encode writes, states, the table; a decoded
    symbol 16 operations, an encoded one 7)."""
    from lvae_tpu_torch.ops import rans_decode as rd, rans_encode as re_
    module = rd if 'decode' in name else re_
    calls = []
    restore = record_calls(module, name, calls)
    try:
        run()
    finally:
        restore()
    fn = getattr(module, name)
    ms = sum(cuda_ms(torch, lambda a=args, k=kw: fn(*a, **k),
                     KERNEL_REPEATS) for args, kw, _ in calls)
    n_bytes = ops = rows = 0
    for args, _, res in calls:
        if 'decode' in name:
            idx, states, ptr, _, cdfs, offs, nsym = args[:7]
            words = int((res[2].long() - ptr.long()).sum())
            B = idx.shape[0] if idx.ndim == 3 else 1
            n_bytes += 4 * (2 * idx.numel() + words + 2 * states.numel()
                            + cdfs.numel() + offs.numel() + 2 * ptr.numel())
            ops += 16 * int(nsym) * B
        else:
            syms, idx, row_n, cdfs = args[:4]
            _, n_words, states = res
            B = idx.shape[0] if idx.ndim == 3 else 1
            n_bytes += 4 * (syms.numel() + idx.numel() + row_n.numel()
                            + cdfs.numel()
                            + int(((n_words.long() + 1) // 2).sum())
                            + states.numel() + n_words.numel())
            ops += 7 * int(row_n.long().sum()) * B
        rows += int(idx.shape[-2])
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return dict(launches=len(calls), ms=ms, rows=rows,
                ns_per_row=ms * 1e6 / max(rows, 1),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by='bytes' if bytes_ms >= ops_ms else 'operations')


def rans_launches(launches):
    return {n: v for n, v in launches.items() if n.startswith('rans_')}


def staged_coders(torch, model, im, kw, what, lossless=False,
                  fused_cfg=None):
    """One model on one image through the legacy fused codec (N = 128),
    then coder='host' and coder='device': each round trip exact, the host
    and device reconstructions bitwise the legacy fused one (a lossless
    model: the pixels, exact), every call's rANS launches counted, the
    device decode's kernel #1 launches timed; encode and decode medians
    (host clock, synchronised). -> (host row, device row or the refusal)."""
    from lvae_tpu_torch.models import staged
    fused_cfg = fused_cfg or {}
    model.compress_mode(num_lanes=128, portable=False, **fused_cfg)
    f_obj, f_rec = model.compress_check(im, **kw)
    f_bytes = len(f_obj) if isinstance(f_obj, bytes) else len(
        pickle.dumps(f_obj))
    f_body = f_obj[10:] if isinstance(f_obj, bytes) else f_obj[0]
    # the legacy fused codec's times on the same yardstick as the coders'
    f_enc_ms, _ = _host_ms(torch, lambda: model.compress(im, **kw),
                           STAGED_REPEATS)
    f_dec_ms, _ = _host_ms(torch, lambda: model.decompress(f_obj),
                           STAGED_REPEATS)
    f_parsed = model._fused.parse_payload(f_body)
    pixels = np.round(im * 255)
    rows = {}
    for coder in ('host', 'device'):
        if coder == 'device' and lossless:
            try:
                model.compress_mode(coder='device')
            except AssertionError as e:
                rows[coder] = dict(refused=True, error=str(e))
                progress(f'{what} device coder refused: {e}')
                continue
            raise AssertionError(f'{what}: the device coder took a lossless '
                                 f'model')
        model.compress_mode(coder=coder)
        (obj, rec), enc_l = counted_call(
            lambda: model.compress_check(im, **kw))
        dec, dec_l = counted_call(lambda: model.decompress(obj))
        n_bytes = len(obj) if isinstance(obj, bytes) else len(
            pickle.dumps(obj))
        exact = bool(np.array_equal(dec, rec))
        if lossless:
            same = bool(np.array_equal(np.round(dec * 255),
                                       np.round(f_rec * 255))
                        and np.array_equal(np.round(dec * 255), pixels))
        else:
            same = bool(np.array_equal(dec, f_rec))
        enc_ms, _ = _host_ms(torch, lambda: model.compress(im, **kw),
                             STAGED_REPEATS)
        dec_ms, _ = _host_ms(torch, lambda: model.decompress(obj),
                             STAGED_REPEATS)
        psnr, bpp = psnr_bpp(dec, im, n_bytes)
        _, fused_bpp = psnr_bpp(f_rec, im, f_bytes)
        row = dict(bytes=n_bytes, bpp=bpp, psnr=psnr,
                   legacy_fused_bytes=f_bytes, legacy_fused_bpp=fused_bpp,
                   bpp_rel_to_legacy_fused=bpp / fused_bpp - 1,
                   round_trip_exact=exact,
                   equal_to_legacy_fused=same, enc_ms=enc_ms, dec_ms=dec_ms,
                   legacy_fused_enc_ms=f_enc_ms, legacy_fused_dec_ms=f_dec_ms,
                   encode_rans_launches=rans_launches(enc_l),
                   decode_rans_launches=rans_launches(dec_l))
        if coder == 'device':
            row['rans_decode_block'] = rans_path_row(
                torch, 'rans_decode_block', lambda: model.decompress(obj))
            payload = obj[10:] if isinstance(obj, bytes) else obj[0]
            row['escapes'] = struct.unpack('<IIH', payload[:10])[1]
            # the native N-lane encoder (host C++) and the CUDA encode
            # kernel, written apart, code the same symbols: the same lane
            # states, words and escapes
            d_parsed = staged.parse_interleaved(payload, 128)
            n_esc = row['escapes']
            row['stream_equal_to_legacy_fused'] = bool(
                all(np.array_equal(a, b) for a, b in
                    zip(d_parsed[:2], f_parsed[:2]))
                and all(np.array_equal(a[:n_esc], b) for a, b in
                        zip(d_parsed[2:], f_parsed[2:])))
            require(row['stream_equal_to_legacy_fused'],
                    f'{what}: the device coder\'s states, words or escapes '
                    f'differ from the legacy fused stream\'s')
        rows[coder] = row
        progress(f'{what} {coder} coder: {bpp:.4f} bpp (legacy fused '
                 f'{fused_bpp:.4f}), exact={exact}, = legacy fused {same}, '
                 f'enc {enc_ms:.1f} ms dec {dec_ms:.1f} ms (legacy fused '
                 f'{f_enc_ms:.1f} / {f_dec_ms:.1f}), rANS '
                 f'{rans_launches(enc_l)} / {rans_launches(dec_l)}')
        require(exact, f'{what} {coder} coder: the round trip is not exact')
        require(same, f'{what} {coder} coder: the reconstruction differs '
                      f'from the legacy fused codec\'s')
        require(not any(enc_l.values()),
                f'{what} {coder} coder: encode launched {enc_l}')
        require(coder == 'device' or not any(dec_l.values()),
                f'{what} host coder: decode launched {dec_l}')
    return rows


def expect_decode_launches(row, what, n_blocks):
    got = row['decode_rans_launches']
    want = dict.fromkeys(got, 0)
    want['rans_decode_block'] = n_blocks
    require(got == want, f'{what}: device decode launched {got}, expected '
                         f'kernel #1 once per latent block ({n_blocks})')
    require(row['rans_decode_block']['launches'] == n_blocks,
            f'{what}: {row["rans_decode_block"]["launches"]} timed launches')


def run_staged(torch, model):
    """The host_coder and device_coder phases: qarv_base with the committed
    weights on photo1 at lambda 2048, qres34m and qres34m_lossless seeded
    as build_qres34m draws them (module docstring, 11-12)."""
    from lvae_tpu_torch.utils import coding
    t = time.perf_counter()
    im = coding.read_png(PHOTO).astype(np.float32)[None] / 255.0
    host, device = {}, {}
    rows = staged_coders(torch, model, im, dict(lmb=STAGED_LMB),
                         'qarv_base')
    require(abs(rows['host']['bpp_rel_to_legacy_fused'])
            <= STAGED_BPP_REL_TOL,
            f'qarv_base host bpp {rows["host"]["bpp"]:.4f} is not within 2 % '
            f'of the legacy fused stream\'s')
    expect_decode_launches(rows['device'], 'qarv_base', 9)
    host['qarv_base'], device['qarv_base'] = rows['host'], rows['device']
    model.compress_mode(num_lanes='auto', portable=True)
    for name, n_blocks in (('qres34m', 12), ('qres34m_lossless', None)):
        qres = build_qres34m(torch, name)
        lossless = n_blocks is None
        rows = staged_coders(
            torch, qres, im, {}, name, lossless=lossless,
            fused_cfg=dict(esc_cap=LOSSLESS_ESC_CAP if lossless
                           else QRES_ESC_CAP))
        if not lossless:
            expect_decode_launches(rows['device'], name, n_blocks)
        host[name], device[name] = rows['host'], rows['device']
        del qres
        torch.cuda.empty_cache()
    common = dict(image=os.path.relpath(PHOTO, ROOT),
                  qarv_base=dict(weights=os.path.relpath(CHECKPOINT, ROOT),
                                 lmb=STAGED_LMB),
                  qres=f'random, flax-style init, seed {QRES_SEED}, '
                       f'prior.c4 redrawn (build_qres34m)',
                  times='host clock, median of 3 after a warm-up, '
                        'synchronised')
    return (dict(common, results=host),
            dict(common, results=device, seconds=time.perf_counter() - t))


def deconv_times(torch, model, run):
    """The transposed-conv upsamplers (common.deconv, a library call:
    torch's ConvTranspose2d in exact float32) of run(): each call's input
    recorded, then each call timed again (CUDA events, median of
    KERNEL_REPEATS) -> dict(calls, ms (their sum), bound_ms, bound_by): the
    bound by the rule of check_kernels, a multiply-add 2 operations (input
    elements x k x k x out channels of them)."""
    from lvae_tpu_torch.models import common
    from lvae_tpu_torch.models.base import exact_f32
    seen = []
    hooks = [blk.register_forward_hook(
        lambda mod, args, out: seen.append((mod, args[0].detach().clone(),
                                            out.numel())))
        for blk in model.net.dec_blocks if isinstance(blk, common.deconv)]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    ms = n_bytes = ops = 0
    with torch.no_grad(), exact_f32():
        for mod, x, n_out in seen:
            ms += cuda_ms(torch, lambda m=mod, a=x: m(a), KERNEL_REPEATS)
            w = mod.conv.weight
            n_bytes += 4 * (x.numel() + n_out + w.numel() + w.shape[1])
            ops += 2 * x.numel() * w[0].numel()
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return dict(calls=len(seen), ms=ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by='bytes' if bytes_ms >= ops_ms else 'operations',
                library_call='torch.nn.ConvTranspose2d (cuDNN, TF32 off, '
                             'deterministic)')


def multi_encode_witness(model, ims_t, bodies):
    """The multi-image encode's bodies (kernel #4's output, kernel #3's
    input) held against an encoder written apart from the CUDA one: each
    image's lane states, words and escapes equal the native N-lane
    encoder's (csrc/crans.cpp) on that image's symbols and indexes, pulled
    from the same B-image legacy trunk (FusedCodecBase.encode_blocks). ->
    one bool an image."""
    from lvae_tpu_torch.ops import crans
    codec = model._fused
    syms, idx = codec.encode_blocks(ims_t)[:2]
    equal = []
    for b, body in enumerate(bodies):
        states, words, escapes = crans.interleaved_encode(
            np.concatenate([s[b] for s in syms]),
            np.concatenate([i[b] for i in idx]), [s.shape[1] for s in syms],
            model._coder.cdf_table, num_lanes=codec.N)
        got = codec.parse_payload(body)
        equal.append(bool(
            np.array_equal(got[0][0], states.view(np.int32))
            and np.array_equal(got[1], words.astype(np.int32))
            and np.array_equal(got[2], escapes[:, 0])
            and np.array_equal(got[3], escapes[:, 1])))
    return equal


def run_qres17m(torch, tmpdir):
    """The qres17m phase: full width, seeded as build_qres34m draws qres34m's
    weights, on the legacy fused codec (B = 1 photo1, B = 2 photo1 and
    photo2) and the host and device coders (module docstring, 13)."""
    from lvae_tpu_torch.utils import coding
    t = time.perf_counter()
    model = build_qres34m(torch, 'qres17m')
    build_s = time.perf_counter() - t
    ims = np.stack([coding.read_png(p) for p in QRES17M_PHOTOS]).astype(
        np.float32) / 255.0
    im = ims[:1]
    cfg = dict(num_lanes=QRES_LANES, esc_cap=QRES_ESC_CAP)
    model.compress_mode(portable=False, **cfg)
    (obj, recon), enc_l = counted_call(lambda: model.compress_check(im))
    dec, dec_l = counted_call(lambda: model.decompress(obj))
    exact = bool(np.array_equal(dec, recon))
    objs, b_enc_l = counted_call(lambda: model.compress_batch(ims))
    bdec, b_dec_l = counted_call(lambda: model.decompress_batch(objs))
    # contiguous, as the entry points pass it: at the scaled posterior's
    # magnitudes cuDNN's choice for other strides moves the symbols
    ims_t = torch.as_tensor(ims, device=model.device).permute(
        0, 3, 1, 2).contiguous()
    bodies, brecon = model._fused.encode_check_batch(ims_t)
    batch_exact = bool([o[0] for o in objs] == bodies
                       and np.array_equal(bdec, brecon))
    # kernels #3 and #4 against the native encoder, on the seeded weights
    # and with channel 0 of the last latent block's posterior x3000 (as
    # run_qres: escapes in both images); the weights restored after
    batch = dict(seeded=dict(
        escapes=[struct.unpack('<IIH', b[:10])[1] for b in bodies],
        round_trip_exact=batch_exact,
        equal_to_native_encoder=multi_encode_witness(model, ims_t, bodies)))
    c4 = [b for b in model.net.dec_blocks
          if getattr(b, 'is_latent_block', False)][-1].posterior.c4
    kept = c4.weight.detach().clone()
    with torch.no_grad():
        c4.weight[0].mul_(3000.0)
    eobjs = model.compress_batch(ims)
    ebodies, ebrecon = model._fused.encode_check_batch(ims_t)
    batch['scaled_posterior'] = dict(
        escapes=[struct.unpack('<IIH', b[:10])[1] for b in ebodies],
        round_trip_exact=bool(
            [o[0] for o in eobjs] == ebodies
            and np.array_equal(model.decompress_batch(eobjs), ebrecon)),
        equal_to_native_encoder=multi_encode_witness(model, ims_t, ebodies))
    with torch.no_grad():
        c4.weight.copy_(kept)
    progress(f'qres17m B = 2 against the native encoder: {batch}')
    n_words, n_esc, lanes_field = struct.unpack('<IIH', obj[0][:10])
    psnr, bpp = psnr_bpp(dec, im, len(pickle.dumps(obj)))
    im_dev = torch.as_tensor(im, device=model.device)
    enc_ms, o = _host_ms(torch, lambda: model.compress(im_dev), 5)
    dec_ms, _ = _host_ms(torch, lambda: model.decompress_to_device(
        o[0], o[1][1], o[1][2]), 5)
    paths = {
        'rans_encode_all': rans_path_row(
            torch, 'rans_encode_all', lambda: model.compress(im)),
        'rans_decode_block': rans_path_row(
            torch, 'rans_decode_block', lambda: model.decompress(obj)),
        'rans_encode_all_multi': rans_path_row(
            torch, 'rans_encode_all_multi',
            lambda: model.compress_batch(ims)),
        'rans_decode_block_multi': rans_path_row(
            torch, 'rans_decode_block_multi',
            lambda: model.decompress_batch(objs))}
    deconv = deconv_times(torch, model, lambda: model.decompress(obj))
    # the refusals: no portable kernel for the deconv
    refusals = {}
    for what, call in (
            ('compress_mode(portable=True)',
             lambda: model.compress_mode(portable=True, **cfg)),
            ('compress_file() in fused mode',
             lambda: model.compress_file(PHOTO, os.path.join(
                 tmpdir, 'qres17m.bits')))):
        model.compress_mode(portable=False, **cfg)
        try:
            call()
        except NotImplementedError as e:
            refusals[what] = str(e)
        else:
            raise AssertionError(f'qres17m: {what} did not raise')
    staged = staged_coders(torch, model, im, {}, 'qres17m',
                           fused_cfg=dict(esc_cap=QRES_ESC_CAP))
    expect_decode_launches(staged['device'], 'qres17m', 12)
    zero = dict.fromkeys(rans_launches(enc_l), 0)
    want = {'encode': dict(zero, rans_encode_all=1),
            'decode': dict(zero, rans_decode_block=12),
            'batch_encode': dict(zero, rans_encode_all_multi=1),
            'batch_decode': dict(zero, rans_decode_block_multi=12)}
    got = {'encode': rans_launches(enc_l), 'decode': rans_launches(dec_l),
           'batch_encode': rans_launches(b_enc_l),
           'batch_decode': rans_launches(b_dec_l)}
    trunk_launches = {n: v for l in (enc_l, dec_l, b_enc_l, b_dec_l)
                      for n, v in l.items() if v and not n.startswith('rans')}
    result = dict(
        model='qres17m', params=model.num_params(), build_s=build_s,
        weights=f'random, flax-style init, seed {QRES_SEED}, prior.c4 '
                'redrawn (build_qres34m)', trunk='legacy (library convs, '
        'the deconvs ConvTranspose2d)', lanes=lanes_field, esc_cap=QRES_ESC_CAP,
        image=os.path.relpath(PHOTO, ROOT),
        batch_images=[os.path.relpath(p, ROOT) for p in QRES17M_PHOTOS],
        bpp=bpp, psnr=psnr, escapes=n_esc, n_words=n_words,
        round_trip_exact=exact, batch_round_trip_exact=batch_exact,
        batch=batch, enc_ms=enc_ms, dec_ms=dec_ms,
        times="bench.py's qres34m workload: host clock, median of 5, "
              "synchronised", launches=got, rans_paths=paths, deconv=deconv,
        refusals=refusals, staged=staged,
        host_device_fused_bitwise=bool(
            staged['host']['equal_to_legacy_fused']
            and staged['device']['equal_to_legacy_fused']),
        seconds=time.perf_counter() - t)
    progress(f'qres17m: {bpp:.4f} bpp {psnr:.2f} dB, exact={exact}, '
             f'B = 2 exact={batch_exact}, enc {enc_ms:.1f} ms dec '
             f'{dec_ms:.1f} ms')
    require(exact, 'qres17m: the legacy fused round trip is not exact')
    require(batch_exact, 'qres17m: the B = 2 round trip is not exact')
    for what, r in batch.items():
        require(r['round_trip_exact'] and all(r['equal_to_native_encoder']),
                f'qres17m B = 2 {what}: {r}')
    require(min(batch['scaled_posterior']['escapes']) > 0,
            'qres17m B = 2: the scaled posterior gave no escape')
    require(got == want, f'qres17m: rANS launches {got}, expected {want}')
    require(not trunk_launches,
            f'qres17m: the legacy trunk launched {trunk_launches}')
    require(np.isfinite(dec).all() and dec.shape == im.shape,
            'qres17m: bad reconstruction')
    del model
    torch.cuda.empty_cache()
    return result


# ---- the RD model, sampling and the original project's checkpoints -------
# (no kernel of csrc/ runs on these paths: library convolutions and
# products under exact float32)

RD_SEED = 20
# the RD models' parameter counts, the JAX trees' (tests/test_torch_rd_zoo.py)
RD_PARAMS = {'rd_model_base': 186670384,
             'rd_ablation_c64_l5_nosmooth': 34178160,
             'rd_ablation_c64_l5': 34178160,
             'rd_ablation_c64_l10': 46111344,
             'rd_ablation_c64_l15': 55792496,
             'rd_ablation_c96_l15': 111829072,
             'rd_ablation_c128_l10': 147485616,
             'rd_ablation_base_nosmooth': 186670384}
RD_LMBS = (4.0, 64.0, 2048.0)
RD_REPEATS = 5
RD_STATS_RTOL, RD_PSNR_DB = 1e-4, 1e-3
SAMPLE_T0_ATOL = 1e-4          # t = 0 samples, card against the CPU
COND_ATOL = 1e-5               # the decoder on its own latents vs reconstruct
SAMPLE_LMB = 2048.0
SAMPLE_TIMES = (f'CUDA events (host arrays in and out): each call\'s first '
                f'(first_ms) and the median of {RD_REPEATS} after it (ms)')
INPAINT_BOX = (0.25, 0.25, 0.75, 0.75)
# each latent block's z projection (rd: z_proj; QRes: z_proj_1) at this
# share of its flax-style init: at flax init the decoder's features grow
# block by block with the z fed back, until rd_model_base's prior scales
# underflow (its KL inf in float32) and qres34m's prior samples overflow
# (inf, then NaN): random weights, not trained ones, which keep them in
# range. The JAX package does the same at the models' depth
# (tests/test_torch_init_overflow*.py); run_rd and run_sampling require
# the unscaled models to overflow on the card too
ZPROJ_SCALE = 0.1


def warm_timed(torch, fn, repeats=RD_REPEATS):
    """(fn(), its first call's ms, the median of `repeats` calls after it):
    CUDA events; the first call also pays the libraries' first use of its
    shapes."""
    out, first = timed(torch, fn)
    return out, first, cuda_ms(torch, fn, repeats)


def forward_ms(torch, fn, repeats=RD_REPEATS):
    """fn() once to warm up, then the median of `repeats` CUDA-event
    timings (ms), the peak of allocated device memory over them and what
    was allocated before them (the weights and whatever else the process
    holds): the peak less that is the call's own."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ms = cuda_ms(torch, fn, repeats)
    return ms, torch.cuda.max_memory_allocated(), before


def cpu_twin(torch, model):
    """The same handle on the CPU with a copy of the card's weights."""
    import copy
    twin = copy.copy(model)
    twin.device = torch.device('cpu')
    twin.net = copy.deepcopy(model.net).cpu()
    return twin


def scale_zproj(torch, model, name):
    """Each latent block's `name` conv weight times ZPROJ_SCALE."""
    with torch.no_grad():
        for blk in model.net.dec_blocks:
            if getattr(blk, 'is_latent_block', False):
                getattr(blk, name).weight.mul_(ZPROJ_SCALE)


def run_rd(torch, tmpdir):
    """rd_model_base at full width with seeded random weights (flax-style
    init from torch's generator seeded RD_SEED; no trained RD weights
    exist), after each of the eight RD models is built on the card with
    the JAX tree's parameter count: unscaled, its KL on photo1's 256x256
    crop must overflow (inf); then with the z projections scaled
    (ZPROJ_SCALE) the training forward on photo1 at three lambdas (ms, peak
    memory, the operations FlopCounterMode counts and their bound at 67
    TFLOP/s), card against the same seeded weights built on the CPU on the
    crop on the same CPU-drawn noise, unconditional samples at (6, 1, 1)
    and (6, 2, 2) (finite, in [0, 1], bitwise again for the seed), t = 0
    card against CPU, study()'s two PNGs read back."""
    import lvae_tpu_torch
    from torch.utils.flop_counter import FlopCounterMode
    from lvae_tpu_torch.utils import coding
    t0 = time.perf_counter()
    # every registered RD model builds on the card with the JAX tree's
    # parameter count
    built = {}
    for name, n in RD_PARAMS.items():
        t = time.perf_counter()
        m = lvae_tpu_torch.get_model(name)
        built[name] = dict(params=m.num_params(), params_jax=n,
                           device=str(next(m.net.parameters()).device),
                           build_s=time.perf_counter() - t)
        del m
        require(built[name]['params'] == n and
                built[name]['device'].startswith('cuda'),
                f'{name}: {built[name]}')
    torch.cuda.empty_cache()
    t = time.perf_counter()
    torch.manual_seed(RD_SEED)
    model = lvae_tpu_torch.get_model('rd_model_base')
    build_s = time.perf_counter() - t
    n_params = model.num_params()
    progress(f'rd_model_base: {n_params} parameters, built in '
             f'{build_s:.1f} s; the eight RD models: {built}')
    img = coding.read_png(PHOTO)
    im = img.astype(np.float32)[None] / 255.0
    crop = img[:SPREAD_CROP, :SPREAD_CROP].astype(np.float32)[None] / 255.0
    # unscaled, the seeded init overflows: the crop's KL is inf
    unscaled = model.forward(crop, lmb=RD_LMBS[1],
                             generator=torch.Generator().manual_seed(RD_SEED))
    require(not math.isfinite(unscaled['bppix']),
            f'rd_model_base unscaled: finite stats {unscaled}')
    scale_zproj(torch, model, 'z_proj')
    # no gradients here (FlopCounterMode's module hooks want none)
    net = model.net.requires_grad_(False)
    with FlopCounterMode(display=False) as fc:
        net.forward_end2end(model._checked(im), model._lmbs(64.0, 1))
    flops = fc.get_total_flops()
    bound_ms = flops / SCALAR_OPS_PER_S * 1e3
    forward = []
    for lmb in RD_LMBS:
        stats = model.forward(im, lmb=lmb)
        require(all(math.isfinite(v) for v in stats.values()),
                f'rd forward at lambda {lmb:g}: {stats}')
        ms, peak, before = forward_ms(torch,
                                      lambda: model.forward(im, lmb=lmb))
        forward.append(dict(lmb=lmb, stats=stats, ms=ms, peak_bytes=peak,
                            allocated_before_bytes=before,
                            forward_peak_bytes=peak - before))
        progress(f'rd forward lambda {lmb:g}: {stats}, {ms:.2f} ms, peak '
                 f'{peak / 2**30:.2f} GiB ({(peak - before) / 2**30:.2f} '
                 f'GiB over the {before / 2**30:.2f} held before)')
    # card against the CPU on the crop, the noise drawn on the CPU; the
    # CPU model built with device='cpu' from the same seed
    torch.manual_seed(RD_SEED)
    cpu = lvae_tpu_torch.get_model('rd_model_base', device='cpu')
    scale_zproj(torch, cpu, 'z_proj')
    card_sd = model.net.state_dict()
    same_init = all(torch.equal(v, card_sd[k].cpu())
                    for k, v in cpu.net.state_dict().items())
    require(same_init, 'rd_model_base: the seeded init differs between '
                       'the card and the CPU')
    vs_cpu = []
    for lmb in (RD_LMBS[0], RD_LMBS[-1]):
        g, c = (m.forward(crop, lmb=lmb,
                          generator=torch.Generator().manual_seed(RD_SEED))
                for m in (model, cpu))
        rel = {k: abs(g[k] / c[k] - 1) for k in ('bppix', 'loss')}
        gap = abs(g['psnr'] - c['psnr'])
        vs_cpu.append(dict(lmb=lmb, card=g, cpu=c, rel_gap=rel,
                           psnr_gap_db=gap))
        require(max(rel.values()) <= RD_STATS_RTOL and gap <= RD_PSNR_DB,
                f'rd crop at lambda {lmb:g}: card {g} against CPU {c}')
    samples = {}
    for bhw in ((6, 1, 1), (6, 2, 2)):
        a, first, ms = warm_timed(torch, lambda: model.unconditional_sample(
            SAMPLE_LMB, bhw, seed=1))
        b = model.unconditional_sample(SAMPLE_LMB, bhw, seed=1)
        ok = bool(np.isfinite(a).all() and a.min() >= 0 and a.max() <= 1)
        same = bool(np.array_equal(a, b))
        samples[str(bhw)] = dict(shape=list(a.shape), finite_in_range=ok,
                                 repeats_bitwise=same, ms=ms, first_ms=first)
        require(ok and same and a.shape == (6, 64 * bhw[1], 64 * bhw[2], 3),
                f'rd unconditional_sample {bhw}: {samples[str(bhw)]}')
    a = model.unconditional_sample(SAMPLE_LMB, (6, 1, 1), t=0.0)
    b = cpu.unconditional_sample(SAMPLE_LMB, (6, 1, 1), t=0.0)
    t0_err = float(np.abs(a - b).max())
    require(t0_err <= SAMPLE_T0_ATOL, f'rd t = 0 sample: card against CPU '
                                      f'{t0_err}')
    study = os.path.join(tmpdir, 'rd_study')
    model.study(study)
    pngs = {}
    for k, hw in ((1, 64), (2, 128)):
        path = os.path.join(study, f'samples_k{k}_hw{hw}.png')
        pngs[os.path.basename(path)] = list(coding.read_png(path).shape)
        require(pngs[os.path.basename(path)] == [hw, 6 * hw, 3],
                f'rd study: {path} reads back as {pngs}')
    del cpu, model, net
    torch.cuda.empty_cache()
    out = dict(model='rd_model_base', params=n_params,
               params_jax=RD_PARAMS['rd_model_base'], build_s=build_s,
               registered=built, cpu_init_bitwise=same_init,
               weights=f'random, flax-style init, torch seed {RD_SEED}, '
                       f'z_proj x{ZPROJ_SCALE:g}',
               unscaled_crop_stats={k: repr(v) for k, v in unscaled.items()},
               image=os.path.relpath(PHOTO, ROOT), forward=forward,
               forward_times=f'RDModel.forward (host image to stats), CUDA '
                             f'events, median of {RD_REPEATS} after a warm-up',
               flops=flops, bound_ms=bound_ms, bound_by='operations',
               bound_derivation='FlopCounterMode operations (convolutions '
                                'and products, 2 a multiply-add) / 67 '
                                'TFLOP/s float32',
               card_vs_cpu=dict(crop=f'{SPREAD_CROP}x{SPREAD_CROP}',
                                results=vs_cpu,
                                bounds=f'bppix and loss rtol '
                                       f'{RD_STATS_RTOL:g}, PSNR '
                                       f'{RD_PSNR_DB:g} dB'),
               samples=samples, sample_times=SAMPLE_TIMES,
               t0_card_vs_cpu_max_abs=t0_err,
               study_pngs=pngs, seconds=time.perf_counter() - t0)
    progress(f'rd phase: {out["seconds"]:.1f} s')
    return out


def run_sampling(torch, model, tmpdir):
    """The sampling entry points: qarv_base (the committed weights) and
    qres34m (build_qres34m's seeded weights; unscaled, a (2, 2, 2) prior
    sample must overflow to NaN; then the z projections scaled:
    ZPROJ_SCALE) on photo1: the decoder on forward_get_latents' z against
    the eval reconstruction, t = 0 samples card against CPU, and qres34m's
    two-step inpaint on the 256x256 crop (finite, bitwise again for the
    seed). Each call timed as SAMPLE_TIMES says."""
    import lvae_tpu_torch
    from lvae_tpu_torch.utils import coding
    t0 = time.perf_counter()
    img = coding.read_png(PHOTO)
    im = img.astype(np.float32)[None] / 255.0
    out = {}
    # qarv_base
    lat, lat_first, lat_ms = warm_timed(
        torch, lambda: model.forward_get_latents(im, SAMPLE_LMB))
    z = [st['z'] for st in lat]
    cond, cond_first, cond_ms = warm_timed(
        torch, lambda: model.conditional_sample(SAMPLE_LMB, z))
    rec, rec_first, rec_ms = warm_timed(
        torch, lambda: model.reconstruct(im, SAMPLE_LMB))
    cond_err = float(np.abs(cond - rec).max())
    uncond, uncond_first, uncond_ms = warm_timed(
        torch, lambda: model.unconditional_sample(SAMPLE_LMB, (2, 1, 1),
                                                  t=0.0))
    cpu = lvae_tpu_torch.get_model('qarv_base', pretrained=CHECKPOINT,
                                   device='cpu')
    t0_err = float(np.abs(uncond - cpu.unconditional_sample(
        SAMPLE_LMB, (2, 1, 1), t=0.0)).max())
    del cpu
    out['qarv_base'] = dict(
        lmb=SAMPLE_LMB, latents=len(z), cond_vs_reconstruct_max_abs=cond_err,
        cond_bitwise=bool(np.array_equal(cond, rec)),
        t0_card_vs_cpu_max_abs=t0_err, forward_get_latents_ms=lat_ms,
        conditional_sample_ms=cond_ms, reconstruct_ms=rec_ms,
        unconditional_sample_2x1x1_ms=uncond_ms,
        first_ms=dict(forward_get_latents=lat_first,
                      conditional_sample=cond_first,
                      reconstruct=rec_first,
                      unconditional_sample_2x1x1=uncond_first))
    require(cond_err <= COND_ATOL, f'qarv_base: conditional_sample on its '
                                   f'latents is {cond_err} from reconstruct')
    require(t0_err <= SAMPLE_T0_ATOL, f'qarv_base t = 0: card against CPU '
                                      f'{t0_err}')
    # qres34m: unscaled, the seeded init overflows: a prior sample on a
    # (2, 2, 2) grid (CPU-drawn noise) holds NaN
    qm = build_qres34m(torch)
    unscaled = qm.uncond_sample((2, 2, 2), temprature=1.0,
                                generator=torch.Generator().manual_seed(0))
    unscaled_nan = int(np.isnan(unscaled).sum())
    require(unscaled_nan > 0, 'qres34m unscaled: the (2, 2, 2) prior sample '
                              'is finite')
    scale_zproj(torch, qm, 'z_proj_1')
    lat, lat_first, lat_ms = warm_timed(torch,
                                        lambda: qm.forward_get_latents(im))
    z = [st['z'] for st in lat]
    cond, cond_first, cond_ms = warm_timed(torch, lambda: qm.cond_sample(z))
    rec, rec_first, rec_ms = warm_timed(torch, lambda: qm.reconstruct(im))
    cond_err = float(np.abs(cond - rec).max())
    uncond, uncond_first, uncond_ms = warm_timed(torch, lambda: (
        qm.uncond_sample((2, 1, 1), temprature=0.0)))
    cpu = cpu_twin(torch, qm)
    t0_err = float(np.abs(uncond - cpu.uncond_sample(
        (2, 1, 1), temprature=0.0)).max())
    del cpu
    crop = img[:SPREAD_CROP, :SPREAD_CROP].astype(np.float32)[None] / 255.0
    a, inpaint_first, inpaint_ms = warm_timed(
        torch, lambda: qm.inpaint(crop, INPAINT_BOX, steps=2, seed=3))
    b = qm.inpaint(crop, INPAINT_BOX, steps=2, seed=3)
    ok = bool(np.isfinite(a).all() and a.shape == crop.shape)
    same = bool(np.array_equal(a, b))
    out['qres34m'] = dict(
        weights=f'random, flax-style init, seed {QRES_SEED}, prior.c4 '
                f'redrawn (build_qres34m), z_proj_1 x{ZPROJ_SCALE:g}',
        unscaled_2x2x2_sample_nan=unscaled_nan,
        unscaled_2x2x2_sample_values=int(unscaled.size),
        latents=len(z),
        cond_vs_reconstruct_max_abs=cond_err,
        cond_bitwise=bool(np.array_equal(cond, rec)),
        t0_card_vs_cpu_max_abs=t0_err, inpaint_finite=ok,
        inpaint_repeats_bitwise=same, forward_get_latents_ms=lat_ms,
        cond_sample_ms=cond_ms, reconstruct_ms=rec_ms,
        uncond_sample_2x1x1_ms=uncond_ms, inpaint_two_steps_ms=inpaint_ms,
        first_ms=dict(forward_get_latents=lat_first, cond_sample=cond_first,
                      reconstruct=rec_first, uncond_sample_2x1x1=uncond_first,
                      inpaint_two_steps=inpaint_first),
        inpaint=f'{SPREAD_CROP}x{SPREAD_CROP} crop of photo1, box '
                f'{INPAINT_BOX}, steps 2')
    del qm
    torch.cuda.empty_cache()
    require(cond_err <= COND_ATOL, f'qres34m: cond_sample on its latents is '
                                   f'{cond_err} from reconstruct')
    require(t0_err <= SAMPLE_T0_ATOL, f'qres34m t = 0: card against CPU '
                                      f'{t0_err}')
    require(ok and same, f'qres34m inpaint: finite {ok}, repeats {same}')
    out['image'] = os.path.relpath(PHOTO, ROOT)
    out['times'] = SAMPLE_TIMES
    out['seconds'] = time.perf_counter() - t0
    progress(f'sampling phase: {out["seconds"]:.1f} s: {out}')
    return out


def original_checkpoint(model):
    """The model's weights as an original-project state dict: each tensor
    under its original key (models/port.py's key map), the layer scales in
    the original's (1, C, 1, 1) shape."""
    from lvae_tpu_torch.models import port
    ours = model.net.state_dict()
    sd = {}
    for key, tk, fn in port.build_key_map(model):
        t = ours[key].detach().cpu().clone()
        sd[tk] = t.reshape(1, -1, 1, 1) if fn is port.t_flat else t
    return sd


def run_torch_checkpoint(torch, model, tmpdir):
    """qarv_base's committed weights written as an original-project .pt
    ({'model': state dict} beside a dummy optimizer state) and loaded
    through get_model(pretrained='*.pt'): the state dict bitwise the
    msgpack-loaded one, and photo1's portable stream at lambda 2048
    byte-identical between the two."""
    import lvae_tpu_torch
    from lvae_tpu_torch.utils import coding
    t0 = time.perf_counter()
    path = os.path.join(tmpdir, 'qarv_base_original.pt')
    torch.save({'model': original_checkpoint(model),
                'optimizer': {'state': {}, 'param_groups': [{'lr': 2e-4}]},
                'iteration': 0}, path)
    size = os.path.getsize(path)
    t = time.perf_counter()
    loaded = lvae_tpu_torch.get_model('qarv_base', pretrained=path)
    load_s = time.perf_counter() - t
    a, b = model.net.state_dict(), loaded.net.state_dict()
    same_sd = a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                           for k in a)
    im = coding.read_png(PHOTO).astype(np.float32)[None] / 255.0
    streams = []
    for m in (model, loaded):
        m.compress_mode(num_lanes='auto', portable=True)
        streams.append(m.compress(im, lmb=SAMPLE_LMB))
    same_bytes = streams[0] == streams[1]
    del loaded
    torch.cuda.empty_cache()
    out = dict(model='qarv_base', weights=os.path.relpath(CHECKPOINT, ROOT),
               pt_bytes=size, tensors=len(a), load_s=load_s,
               state_dict_bitwise=bool(same_sd),
               portable_stream_bytes=len(streams[0]),
               stream_byte_identical=bool(same_bytes), lmb=SAMPLE_LMB,
               seconds=time.perf_counter() - t0)
    progress(f'torch_checkpoint: {out}')
    require(same_sd, 'the .pt-loaded state dict differs from the msgpack '
                     'one')
    require(same_bytes, 'the .pt-loaded model codes other bytes')
    return out


# ---- the bf16 encoder backbone -------------------------------------------------

BF16 = 'bfloat16'
BF16_LAMBDAS = (512.0, 2048.0)
BF16_REPEATS = 3


def enc_ms_pair(torch, set_mode, encode):
    """enc_ms at float32 and at bf16 in one call: a warm-up of each, then
    BF16_REPEATS CUDA-event timings of each in turns; the medians."""
    times = {None: [], BF16: []}
    for cd in times:
        set_mode(cd)
        encode()
    for i in range(BF16_REPEATS):
        for cd in ((None, BF16) if i % 2 == 0 else (BF16, None)):
            set_mode(cd)
            times[cd].append(timed(torch, encode)[1])
    return {'f32' if cd is None else 'bf16': sorted(t)[len(t) // 2]
            for cd, t in times.items()}


def bf16_case(torch, set_mode, compress_check, decompress, encode,
              batch_check, im):
    """One model and trunk at float32 and bf16: the B = 1 round trip, bpp
    and PSNR of the stream, the kernel launches of one encode, the B = 2
    round trip (batch_check) and enc_ms of both."""
    out = {}
    for cd in (None, BF16):
        set_mode(cd)
        stream, recon = compress_check()
        dec = decompress(stream)
        size = len(stream) if isinstance(stream, bytes) else len(stream[0])
        psnr, bpp = psnr_bpp(dec, im, size)
        _, launches = counted_call(encode)
        out['f32' if cd is None else 'bf16'] = dict(
            bpp=bpp, psnr=psnr, bytes=size,
            bit_exact=bool(np.array_equal(dec, recon)),
            batch2_bit_exact=batch_check(),
            encode_launches={k: v for k, v in launches.items() if v})
    out['same_launches'] = out['f32']['encode_launches'] == \
        out['bf16']['encode_launches']
    out['enc_ms'] = enc_ms_pair(torch, set_mode, encode)
    return out


def run_bf16_codec(torch, model, qres_state, tmpdir):
    """compress_mode(compute_dtype='bfloat16'): the encoder backbone alone
    in bf16. qarv_base (the committed weights) on photo1 at lambda 512 and
    2048 on both trunks, and qres34m (run_qres's seeded weights) on photo1
    on the portable trunk: B = 1 and B = 2 (photo1, photo2) round trips
    bitwise, bpp and PSNR beside float32's (qarv_base's within BPP_REL_TOL
    and PSNR_TOL_DB), the encode's kernel launches equal to float32's,
    enc_ms of both (enc_ms_pair). -> (result, fresh-process cases: a bf16
    portable file of each model)."""
    import lvae_tpu_torch
    from lvae_tpu_torch.utils import coding
    t0 = time.perf_counter()
    u8 = np.stack([coding.read_png(p) for p in QRES_PHOTOS])
    ims = u8.astype(np.float32) / 255.0
    im = ims[:1]
    ims_t = torch.as_tensor(ims, device=model.device).permute(0, 3, 1, 2)
    rows = []
    for portable in (True, False):
        for lmb in BF16_LAMBDAS:
            def set_mode(cd, portable=portable):
                model.compress_mode(num_lanes='auto', portable=portable,
                                    compute_dtype=cd)

            def batch_check(lmb=lmb):
                objs = model.compress_batch(ims, lmb=lmb)
                _, want = model._fused.encode_check_batch(
                    ims_t.contiguous(),
                    torch.full((2,), lmb, device=model.device))
                return bool(np.array_equal(model.decompress_batch(objs),
                                           want))
            row = bf16_case(
                torch, set_mode,
                lambda lmb=lmb: model.compress_check(im, lmb=lmb),
                model.decompress, lambda lmb=lmb: model.compress(im, lmb=lmb),
                batch_check, im)
            row.update(model='qarv_base', lmb=lmb,
                       trunk='portable' if portable else 'legacy')
            rows.append(row)
            progress(f'bf16 codec qarv_base {row["trunk"]} lambda {lmb:g}: '
                     f'{row}')
    model.compress_mode(num_lanes='auto', portable=True, compute_dtype=BF16)
    qarv_path = os.path.join(tmpdir, 'photo1.bf16.lmb512.bits')
    model.compress_file(PHOTO, qarv_path, lmb=512.0)
    qarv_rec = model.decompress_file(qarv_path)
    model.compress_mode(num_lanes='auto', portable=True)

    qm = lvae_tpu_torch.get_model('qres34m', device=model.device)
    qm.net.load_state_dict(torch.load(qres_state, map_location=qm.device,
                                      weights_only=True))

    def set_qres(cd):
        qm.compress_mode(num_lanes=QRES_LANES, esc_cap=QRES_ESC_CAP,
                         portable=True, compute_dtype=cd)

    def qres_batch():
        objs = qm.compress_batch(ims)
        _, want = qm._fused.encode_check_batch(ims_t.contiguous())
        return bool(np.array_equal(qm.decompress_batch(objs), want))
    row = bf16_case(torch, set_qres, lambda: qm.compress_check(im),
                    qm.decompress, lambda: qm.compress(im), qres_batch, im)
    row.update(model='qres34m', trunk='portable', weights='run_qres seeded')
    rows.append(row)
    progress(f'bf16 codec qres34m portable: {row}')
    set_qres(BF16)
    qres_path = os.path.join(tmpdir, 'photo1.qres34m.bf16.bits')
    qm.compress_file(QRES_PHOTOS[0], qres_path)
    qres_rec = qm.decompress_file(qres_path)
    del qm
    torch.cuda.empty_cache()
    for row in rows:
        what = f'bf16 {row["model"]} {row["trunk"]} {row.get("lmb", "")}'
        for cd in ('f32', 'bf16'):
            require(row[cd]['bit_exact'] and row[cd]['batch2_bit_exact'],
                    f'{what}: a {cd} round trip is not bit-exact')
        require(row['same_launches'], f'{what}: the encode launches '
                                      f'{row["bf16"]["encode_launches"]}, '
                                      f'not {row["f32"]["encode_launches"]}')
        if row['model'] == 'qarv_base':
            row['bpp_rel_diff'] = row['bf16']['bpp'] / row['f32']['bpp'] - 1
            row['psnr_diff_db'] = row['bf16']['psnr'] - row['f32']['psnr']
            require(abs(row['bpp_rel_diff']) <= BPP_REL_TOL
                    and abs(row['psnr_diff_db']) <= PSNR_TOL_DB,
                    f'{what}: bf16 {row["bf16"]} against f32 {row["f32"]}')
    out = dict(results=rows, image=os.path.relpath(PHOTO, ROOT),
               batch=[os.path.relpath(p, ROOT) for p in QRES_PHOTOS],
               bpp='stream bytes * 8 / pixels (compress(), header included)',
               enc_ms=f'CUDA events around compress() (host image in, bytes '
                      f'out), median of {BF16_REPEATS} in turns after a '
                      f'warm-up of each',
               seconds=time.perf_counter() - t0)
    fresh = [('photo1 bf16 file, lambda 512', 'qarv', qarv_path, qarv_rec),
             ('qres34m photo1 bf16 file', 'qres', qres_path, qres_rec)]
    return out, fresh


# ---- training ------------------------------------------------------------------

TRAIN_STEPS = 5             # of each qarv_base run; the resume adds 2
TRAIN_ARGS = ['--transform', 'crop=256,hflip=True', '--batch_size', '16',
              '--optimizer', 'adam', '--lr', '2e-4', '--lr_sched', 'constant',
              '--val_interval', '0', '--workers', '6', '--data_cache',
              '--probe_device_step']
TRAIN_RUNS = (('f32', []), ('amp', ['--amp']),
              ('amp_remat', ['--amp', '--remat']),
              ('f32_device_data', ['--device_data']))


def train_row(torch, t):
    """What a finished trainer shows: each step's loss and grad norm
    (required finite), the step time (host clock between the metric pulls,
    median after the first two steps; the device time alone and its peak
    memory from --probe_device_step), the operations of a step
    (trainer._count_step_flops) and their bound at the card's dense peak
    for the compute dtype, the run's peak memory, the run directory's
    files."""
    from lvae_tpu_torch.training.trainer import PEAK_FLOPS
    hist = t.history
    secs = [h['seconds'] for h in hist[2:] if h['seconds'] is not None]
    peak = PEAK_FLOPS[t.compute_dtype or 'float32']
    row = dict(steps=[h['step'] for h in hist],
               loss=[h['loss'] for h in hist],
               grad_norm=[h['grad_norm'] for h in hist],
               step_ms=1e3 * float(np.median(secs)) if secs else None,
               device_step_ms=t._device_step_ms,
               step_tflop=t._step_flops / 1e12,
               bound_ms=t._step_flops / peak * 1e3,
               bound_peak_tflops=peak / 1e12,
               step_peak_gb=t.step_peak_bytes / 1e9
               if t.step_peak_bytes is not None else None,
               run_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               files=sorted(os.listdir(t._log_dir)),
               compute_dtype=t.compute_dtype or 'float32',
               remat=bool(t.cfg.remat), device_data=bool(t.cfg.device_data),
               results={k: v for k, v in t._results.items()
                        if isinstance(v, (int, float))})
    require(hist and all(math.isfinite(h['loss'])
                         and math.isfinite(h['grad_norm']) for h in hist),
            f'non-finite training step: {row}')
    return row


def run_train(torch, tmpdir):
    """The two train CLIs on the card. train_var_rate on qarv_base from the
    committed weights, the PNGs of images/ as training and validation set
    (copied to the temporary directory, decoded once by --data_cache),
    crop 256, batch 16, Adam at lr 2e-4, TRAIN_STEPS steps, in each of
    TRAIN_RUNS (f32, --amp, --amp --remat, and f32 from the device cache),
    then a --resume of the f32 run for 2 more steps; the f32 run again in
    a process group of one on NCCL (parallel/mesh.init_distributed(backend=
    'nccl'); the step's all_reduce runs), whose parameters must equal the
    f32 run's bitwise (dp_nccl1); train_fix_rate on qres34m
    (build_qres34m's weights, the z projections scaled by ZPROJ_SCALE where
    the unscaled loss of a training batch is not finite), 3 steps. Each
    run in this process through the CLI's main() (working directory: the
    temporary one). -> (the dp_nccl1 line, the train line)."""
    import torch.distributed as dist
    from lvae_tpu_torch.parallel import mesh as pmesh
    from lvae_tpu_torch import train_fix_rate, train_var_rate
    from lvae_tpu_torch.training import checkpoint as ckpt
    t0 = time.perf_counter()
    data = os.path.join(tmpdir, 'trainset')
    os.makedirs(data)
    for name in sorted(os.listdir(os.path.join(ROOT, 'images'))):
        if name.endswith('.png'):
            shutil.copy(os.path.join(ROOT, 'images', name), data)
    common = ['--trainset', data, '--valset', data] + TRAIN_ARGS
    here = os.getcwd()
    os.chdir(tmpdir)
    runs, flats = {}, {}
    try:
        def run(cli, label, argv):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            trainer = cli.main(argv)
            row = train_row(torch, trainer)
            row['seconds'] = time.perf_counter() - t
            if label in ('f32', 'dp_nccl1'):
                flats[label] = trainer.state.flat.cpu()
            # a qarv_base checkpoint is 1.9 GB: keep only what the resume
            # reads
            for name in ('best', 'last_ema', 'best_ema', 'last'):
                path = os.path.join(trainer._log_dir, name)
                if os.path.exists(path) and (
                        name != 'last' or label not in ('f32', 'resume')):
                    row.setdefault('checkpoint_bytes', {})[name] = \
                        os.path.getsize(path)
                    os.remove(path)
            del trainer
            gc_cuda(torch)
            progress(f'train {label}: {row}')
            return row

        qarv = ['--model', 'qarv_base', '--weights', CHECKPOINT,
                '--val_steps', '2'] + common
        for label, extra in TRAIN_RUNS:
            runs[label] = run(train_var_rate, label, qarv + [
                '--iterations', str(TRAIN_STEPS), '--name', label] + extra)
            require({'last', 'best', 'last_ema', 'config.json', 'model.txt',
                     'optimizer.json'} <= set(runs[label]['files']),
                    f'{label}: checkpoint files missing')
        resumed = run(train_var_rate, 'resume', [
            '--model', 'qarv_base', '--iterations', str(TRAIN_STEPS + 2),
            '--resume', 'f32', '--val_steps', '2'] + common)
        require(resumed['steps'] == [TRAIN_STEPS, TRAIN_STEPS + 1],
                f'the resume ran steps {resumed["steps"]}')
        saved = ckpt.load_checkpoint(os.path.join('runs', 'default', 'f32',
                                                  'last'))
        require(saved['state']['step'] == TRAIN_STEPS + 2,
                'the resumed run did not carry on the step')
        runs['resume'] = resumed

        # dp_nccl1: the f32 run through a process group of one on NCCL
        pmesh.init_distributed(backend='nccl')
        try:
            nccl1 = run(train_var_rate, 'dp_nccl1', qarv + [
                '--iterations', str(TRAIN_STEPS), '--name', 'dp_nccl1'])
            nccl1.update(backend=dist.get_backend(), world_size=
                         dist.get_world_size())
        finally:
            dist.destroy_process_group()
        nccl1['bitwise_f32_run'] = torch.equal(flats['dp_nccl1'],
                                               flats['f32'])
        require(nccl1['bitwise_f32_run'], 'dp_nccl1: the parameters differ '
                'from the run without a process group')
        del flats

        # qres34m from build_qres34m's weights, as a weights file; its
        # step-0 loss unscaled on a batch of the training set, as the
        # train step computes it
        model = build_qres34m(torch)
        from lvae_tpu_torch.datasets import get_image_dataset
        from lvae_tpu_torch.datasets.loader import batch_rng
        from lvae_tpu_torch.models.base import exact_f32
        ds = get_image_dataset(data, 'crop=256,hflip=True')
        rng = batch_rng(0, 0, 0)
        ims = np.stack([ds.get(i % len(ds), rng) for i in range(16)])
        with exact_f32(), torch.no_grad():
            loss, _ = model.loss_and_stats(
                torch.as_tensor(ims, device=model.device).permute(
                    0, 3, 1, 2).contiguous(),
                generator=torch.Generator(model.device).manual_seed(0))
        step0 = float(loss)
        scaled_zproj = not math.isfinite(step0)
        if scaled_zproj:
            scale_zproj(torch, model, 'z_proj_1')
        weights = os.path.join(tmpdir, 'qres34m_train_start.pt')
        ckpt.save_weights(weights, model.net)
        del model

        def fix(name, steps):
            return ['--model', 'qres34m', '--weights', weights, '--name',
                    name, '--iterations', str(steps)] + common
        runs['qres34m'] = run(train_fix_rate, 'qres34m', fix('qres34m', 3))
        runs['qres34m'].update(unscaled_step0_loss=step0,
                               zproj_scaled=scaled_zproj)
    finally:
        os.chdir(here)
    return nccl1, dict(runs=runs, trainset=os.path.relpath(
        os.path.join(ROOT, 'images'), ROOT) + '/*.png',
        args=TRAIN_ARGS, steps=TRAIN_STEPS,
        step_ms='host clock between metric pulls, median of steps >= 2',
        device_step_ms='CUDA events around one step alone, median of 3 '
                       'after a warm-up (--probe_device_step)',
        bound_ms="a step's operations (the forward's convolutions and "
                 "products by FlopCounterMode, x 3, x 4 with --remat: "
                 "trainer._count_step_flops) / the dense peak (67 TFLOP/s "
                 "float32, 989 TFLOP/s bf16)",
        seconds=time.perf_counter() - t0)


# the multi-process phases (lvae_tpu_torch/parallel/): DIST_RANKS processes
# of torchrun share cuda:0 over gloo (NCCL takes one card a rank), each
# phase's row written by rank 0 to the work directory (run_distributed)
DIST_RANKS = 4
DIST_PHASES = ('dp_gloo2', 'spatial', 'dp_sp')
DIST_TIMEOUT = 420          # s, the torchrun launch of the three phases
NCCL_PROBE_TIMEOUT = 90     # s, NCCL's two ranks on the one card
DIST_SEEDS = (42, 43)       # the steps' noise generators, the same a rank
DP_BATCH = 16               # global: 8 a rank at two ranks
DPSP_BATCH = 4              # the 2x2 (data, space) step's global batch
DIST_LR, DIST_EMA = 2e-4, 0.999
# against the one-process step: the loss, and each element of the first
# step's averaged gradient (the summation orders of batch 16 and of two
# batches of 8, or of slabs, differ)
DIST_LOSS_RTOL, DIST_ATOL = 1e-5, 5e-6
SPATIAL_RTOL = 1e-5         # spatial_eval against the unsharded forward
SPATIAL_LMB = 512.0
ALLREDUCE_REPEATS = 3

NCCL_PROBE = '''
import torch, torch.distributed as dist
from lvae_tpu_torch.parallel import mesh
mesh.init_distributed(backend='nccl', device='cuda:0')
t = torch.ones(4, device='cuda:0')
dist.all_reduce(t)
torch.cuda.synchronize()
print('NCCL_ALL_REDUCE', t.tolist(), flush=True)
dist.destroy_process_group()
'''


def dist_crops(batch):
    """`batch` 256x256 crops of images/*.png (RandomCropFlip, the trainer's
    per-batch rng of batch 0) -> NHWC float32 numpy in [0, 1]."""
    from lvae_tpu_torch.datasets import get_image_dataset
    from lvae_tpu_torch.datasets.loader import batch_rng
    ds = get_image_dataset(os.path.join(ROOT, 'images'),
                           'crop=256,hflip=True')
    rng = batch_rng(0, 0, 0)
    return np.stack([ds.get(i % len(ds), rng) for i in range(batch)])


def dist_steps(torch, model, weights, batch, mesh):
    """len(DIST_SEEDS) Adam steps of `model` from `weights` on the global
    NHWC `batch` (this rank's block of it under `mesh`; all of it with
    mesh None), each timed on the host clock to a synchronize -> {state,
    metrics: the last step's as floats, ms: of each step, grad: the first
    step's averaged gradient, replicate_ms: the broadcast of the state
    from the mesh's first rank}. The gradient comes from a micro-step at
    accum_num=2 on a state of its own, which leaves it in grad_accum,
    halved."""
    from lvae_tpu_torch import parallel
    from lvae_tpu_torch.parallel import image_sharding
    from lvae_tpu_torch.training.optim import TrainState, make_train_step

    def loss_fn(b, g):
        return model.loss_and_stats(b, training=True, generator=g)
    if mesh is not None:
        batch = image_sharding(mesh).local(batch)
    x = torch.from_numpy(np.ascontiguousarray(batch)).to(
        model.device).permute(0, 3, 1, 2).contiguous()
    model.net.load_state_dict(weights)
    state = TrainState(model.net, optimizer='sgd', ema=False)
    make_train_step(loss_fn, state, accum_num=2, mesh=mesh)(
        x, torch.Generator(model.device).manual_seed(DIST_SEEDS[0]),
        DIST_LR, 1e9, DIST_EMA)
    grad = state.grad_accum * 2
    del state
    model.net.load_state_dict(weights)
    state = TrainState(model.net, optimizer='adam', ema=True)
    replicate_ms = None
    if mesh is not None:
        # the trainer's start: every rank takes the first rank's state
        torch.cuda.synchronize()
        t = time.perf_counter()
        parallel.replicate(state, mesh)
        torch.cuda.synchronize()
        replicate_ms = 1e3 * (time.perf_counter() - t)
    step = make_train_step(loss_fn, state, grad_clip=2.0, use_ema=True,
                           mesh=mesh)
    ms = []
    for seed in DIST_SEEDS:
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = step(x, torch.Generator(model.device).manual_seed(seed),
                       DIST_LR, 1e9, DIST_EMA)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
    return dict(state=state, metrics={k: float(v) for k, v in
                                      metrics.items()},
                ms=ms, grad=grad, replicate_ms=replicate_ms)


def step_gaps(torch, state, grad, ref):
    """max |a - b| of the first step's gradient, and of the parameters and
    the EMA after the steps, against `ref`'s; the gradient's gap over its
    largest element, and the L2 norm of the difference over the norm."""
    d = grad - ref['grad']
    return dict(
        grad_max_abs=float(d.abs().max()),
        grad_max=float(ref['grad'].abs().max()),
        grad_rel_l2=float(torch.linalg.vector_norm(d)
                          / torch.linalg.vector_norm(ref['grad'])),
        params_max_abs=float((state.flat - ref['flat']).abs().max()),
        ema_max_abs=float((state.ema - ref['ema']).abs().max()))


def dist_phase_row(torch, dist_utils, name, mesh, one, dp, extra):
    """A DP step's row on rank 0 (None elsewhere), after every rank of the
    mesh held its state bitwise equal to the others'. Against the one-
    process step it requires the loss and the first step's averaged
    gradient (DIST_LOSS_RTOL, DIST_ATOL) and reports the parameters' and
    the EMA's gaps after the steps: Adam divides each gradient element by
    its own magnitude, so an element whose gradient is rounding noise
    moves by up to the LR whichever way its sum was rounded (ROADMAP C)."""
    state, metrics = dp['state'], dp['metrics']
    bitwise = dist_utils.check_model_equivalence(state, mesh)
    if not mesh.includes_me or mesh.coords != {k: 0 for k in mesh.shape}:
        return None
    gaps = step_gaps(torch, state, dp['grad'], one['state'])
    row = dict(ranks=mesh.size, mesh=dict(mesh.shape), bitwise=bitwise,
               loss=metrics['loss'], one_process_loss=one['loss'],
               grad_norm=metrics['grad_norm'], step_ms=dp['ms'],
               one_process_step_ms=one['ms'], lr=DIST_LR,
               replicate_ms=dp['replicate_ms'],
               state_bytes=sum(t.numel() * t.element_size()
                               for t in state.flat_buffers().values()),
               **gaps, **extra)
    require(bitwise, f'{name}: the ranks disagree')
    require(gaps['grad_max_abs'] <= DIST_ATOL
            and abs(metrics['loss'] - one['loss'])
            <= DIST_LOSS_RTOL * abs(one['loss']),
            f'{name}: off the one-process step: {row}')
    return row


def one_process(torch, model, weights, batch):
    """The reference: the steps on one process, the whole batch."""
    dp = dist_steps(torch, model, weights, batch, None)
    state = dp['state']
    ref = dict(state={'flat': state.flat.clone(), 'ema': state.ema.clone(),
                      'grad': dp['grad']}, loss=dp['metrics']['loss'],
               ms=dp['ms'])
    del state, dp
    gc_cuda(torch)
    return ref


def timed_exchange(torch, spatial):
    """Wraps the halo exchange's forward to sum its time (to a
    synchronize) -> (the running totals, the undo)."""
    real = spatial._HaloPad.forward
    tot = {'ms': 0.0, 'calls': 0}

    def forward(ctx, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(ctx, *args)
        torch.cuda.synchronize()
        tot['ms'] += 1e3 * (time.perf_counter() - t)
        tot['calls'] += 1
        return out
    spatial._HaloPad.forward = staticmethod(forward)

    def undo():
        spatial._HaloPad.forward = staticmethod(real)
    return tot, undo


def sharded_eval(torch, parallel, model, im, n_space, lmb):
    """spatial_eval at (1, n_space): its stats, the ms of a second call, and
    a third call with the exchange timed (exchange_ms, its share)."""
    from lvae_tpu_torch.parallel import spatial
    mesh = parallel.get_2d_mesh(1, n_space)
    parallel.spatial_eval(model, im, mesh, lmb=lmb)
    torch.cuda.synchronize()
    t = time.perf_counter()
    stats = parallel.spatial_eval(model, im, mesh, lmb=lmb)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t)
    tot, undo = timed_exchange(torch, spatial)
    try:
        t = time.perf_counter()
        parallel.spatial_eval(model, im, mesh, lmb=lmb)
        torch.cuda.synchronize()
        timed_ms = 1e3 * (time.perf_counter() - t)
    finally:
        undo()
    return stats, dict(ms=ms, exchange_ms=tot['ms'],
                       exchange_calls=tot['calls'],
                       exchange_share=tot['ms'] / timed_ms,
                       ms_with_exchange_timed=timed_ms)


def spatial_rows(torch, parallel, dist_utils, model, im, lmb, spaces):
    """spatial_eval of `model` on `im` at (1, n) for n in spaces against
    the unsharded forward of rank 0 (rank 0's rows; None elsewhere)."""
    rank = parallel.process_index()
    kw = {} if lmb is None else {'lmb': lmb}
    ref, unsharded_ms = None, None
    if rank == 0:
        model.forward(im, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ref = model.forward(im, **kw)
        unsharded_ms = 1e3 * (time.perf_counter() - t)
    ref = dist_utils.broadcast_object(ref)
    rows = {}
    for n in spaces:
        stats, times = sharded_eval(torch, parallel, model, im, n, lmb)
        if rank == 0:
            rel = {k: abs(stats[k] - ref[k]) / abs(ref[k])
                   for k in ('loss', 'bppix', 'psnr')}
            rows[f'1x{n}'] = dict(stats=stats, rel_gap=rel, **times)
            require(all(math.isfinite(stats[k]) for k in rel)
                    and max(rel.values()) <= SPATIAL_RTOL,
                    f'spatial_eval at (1, {n}) off the unsharded forward: '
                    f'{stats} against {ref}')
    return (dict(unsharded=ref, unsharded_ms=unsharded_ms, **rows)
            if rank == 0 else None)


def rank_phases(work):
    """One rank of the shared-card phases (run_distributed launches
    DIST_RANKS of them with torchrun): dp_gloo2, spatial and dp_sp on
    cuda:0 over gloo. Rank 0 writes each phase's row to work/<phase>.json
    and raises where a check fails (torchrun then stops the others)."""
    import torch
    import lvae_tpu_torch
    from lvae_tpu_torch import parallel
    from lvae_tpu_torch.models.base import exact_f32
    from lvae_tpu_torch.parallel import dist_utils
    from lvae_tpu_torch.utils import coding
    parallel.init_distributed(backend='gloo', device='cuda:0')
    rank = parallel.process_index()

    def write(name, row, t0):
        if rank == 0:
            row['seconds'] = time.perf_counter() - t0
            with open(os.path.join(work, f'{name}.json'), 'w') as f:
                json.dump(row, f)

    model = lvae_tpu_torch.get_model('qarv_base', pretrained=CHECKPOINT)
    weights = {k: v.clone() for k, v in model.net.state_dict().items()}
    with exact_f32():
        # dp_gloo2: two ranks, 8 images each, against one process's 16
        t0 = time.perf_counter()
        batch = dist_crops(DP_BATCH)
        one = one_process(torch, model, weights, batch) if rank == 0 \
            else None
        dist_utils.barrier('one-process step')
        mesh = parallel.get_data_mesh(ranks=[0, 1])
        row = None
        if mesh.includes_me:
            flat = torch.zeros(sum(p.numel() for p in model.net.parameters()),
                               device=model.device)
            ms = []
            for _ in range(ALLREDUCE_REPEATS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                mesh.mean(flat)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t))
            extra = dict(gradient_bytes=flat.numel() * 4,
                         allreduce_ms=ms)
            del flat
            dp = dist_steps(torch, model, weights, batch, mesh)
            row = dist_phase_row(torch, dist_utils, 'dp_gloo2', mesh, one,
                                 dp, extra)
            del dp
        write('dp_gloo2', row, t0)
        gc_cuda(torch)
        dist_utils.barrier('dp_gloo2')

        # spatial: qarv_base at (1, 2) and (1, 4), qres34m at (1, 2)
        t0 = time.perf_counter()
        model.net.load_state_dict(weights)
        photo = coding.read_png(PHOTO).astype(np.float32)[None] / 255.0
        qarv = spatial_rows(torch, parallel, dist_utils, model, photo,
                            SPATIAL_LMB, (2, 4))
        qres = build_qres34m(torch)
        scaled = False
        if rank == 0:
            scaled = not math.isfinite(qres.forward(photo)['loss'])
        if dist_utils.broadcast_object(scaled):
            scale_zproj(torch, qres, 'z_proj_1')
        qres_rows = spatial_rows(torch, parallel, dist_utils, qres, photo,
                                 None, (2,))
        del qres
        gc_cuda(torch)
        write('spatial', dict(
            image=os.path.relpath(PHOTO, ROOT), qarv_base=dict(
                lmb=SPATIAL_LMB, **(qarv or {})),
            qres34m=dict(zproj_scaled=scaled, **(qres_rows or {}))), t0)
        dist_utils.barrier('spatial')

        # dp_sp: the 2x2 (data, space) step against one process's
        t0 = time.perf_counter()
        batch = dist_crops(DPSP_BATCH)
        one = one_process(torch, model, weights, batch) if rank == 0 \
            else None
        dist_utils.barrier('one-process step')
        mesh = parallel.get_2d_mesh(2, 2)
        dp = dist_steps(torch, model, weights, batch, mesh)
        row = dist_phase_row(torch, dist_utils, 'dp_sp', mesh, one, dp, {})
        write('dp_sp', row, t0)
    dist_utils.barrier('end')
    return 0


def run_group(cmd, timeout, env=None):
    """cmd in a process group of its own, every process of it killed at the
    timeout -> (exit code, or None when it timed out, stdout + stderr)."""
    p = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
        return p.returncode, out
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate()
        return None, out
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()


def torchrun(nprocs, *args):
    return [sys.executable, '-m', 'torch.distributed.run', '--standalone',
            f'--nproc_per_node={nprocs}', *args]


def run_distributed(tmpdir):
    """The shared-card phases (rank_phases, DIST_RANKS processes of
    torchrun) -> {phase: row}; then NCCL at two ranks on the one card, whose
    refusal is recorded, not required (row 'nccl_two_ranks')."""
    work = os.path.join(tmpdir, 'dist')
    os.makedirs(work)
    t = time.perf_counter()
    rc, out = run_group(torchrun(DIST_RANKS, os.path.abspath(__file__),
                                 '--rank-phases', work), DIST_TIMEOUT)
    seconds = time.perf_counter() - t
    require(rc == 0, f'the shared-card phases exited {rc}:\n{out[-6000:]}')
    rows = {}
    for name in DIST_PHASES:
        with open(os.path.join(work, f'{name}.json')) as f:
            rows[name] = json.load(f)
    probe = os.path.join(work, 'nccl_probe.py')
    with open(probe, 'w') as f:
        f.write(NCCL_PROBE)
    t = time.perf_counter()
    rc, out = run_group(torchrun(2, probe), NCCL_PROBE_TIMEOUT,
                        env=dict(os.environ, PYTHONPATH=ROOT))
    said = [l.strip() for l in out.splitlines()
            if 'NCCL' in l or 'Duplicate GPU' in l or 'ncclInvalidUsage' in l]
    rows['nccl_two_ranks'] = dict(
        exit_code=rc, timed_out=rc is None, refused=rc != 0,
        all_reduced='NCCL_ALL_REDUCE' in out, said=said[:12],
        seconds=time.perf_counter() - t)
    rows['launch_seconds'] = seconds
    return rows


def gc_cuda(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on the card',
              file=sys.stderr)
        return 1
    import lvae_tpu_torch
    from lvae_tpu_torch.models.base import exact_f32
    from lvae_tpu_torch.models.qarv.model import QarvModel
    from lvae_tpu_torch.ops import build, cdf
    from lvae_tpu_torch.utils import coding

    device = torch.device('cuda')
    info = build.build()
    build.library()
    emit({'build': info})
    progress(f'kernels built in {info["seconds"]:.1f} s')

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, power = (s.strip() for s in smi.split(',', 1))
    # what a portable stream's bits could follow across runs: the driver
    # and the compiler that built the kernels
    driver = subprocess.run(
        ['nvidia-smi', '--query-gpu=driver_version', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.split()[0]
    nvcc = subprocess.run([build.nvcc_path(), '--version'],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()
    card = {'name': name, 'power_limit': power, 'driver_version': driver,
            'nvcc': nvcc[0],
            'nvcc_release': next(l for l in nvcc if 'release' in l),
            'torch': torch.__version__, 'cuda': torch.version.cuda}
    emit({'card': card})

    table = cdf.build_cdf_table(cdf.default_gaussian_scale_table())
    # the lane counts the main path runs the kernels at
    lanes_of = {lmb: QarvModel._auto_lanes(lmb) for lmb in LAMBDAS}
    rans = check_kernels(torch, np, table, device,
                         sorted(set(lanes_of.values())))
    multi = check_multi_kernels(torch, np, table, device,
                                sorted(set(lanes_of.values())),
                                (2, 3, SERVING_B))
    emit({'multi_kernels': multi})
    # the decode kernel with the lossless head's 128-row table at two lane
    # counts with a ragged last warp, and on its corner cases
    head_table = cdf.build_cdf_table(cdf.lossless_head_scale_table())
    emit({'rans_decode_checks': dict(
        head_table=dict(
            lanes=list(HEAD_TABLE_LANES),
            single=check_kernels(torch, np, head_table, device,
                                 HEAD_TABLE_LANES),
            multi=check_multi_kernels(torch, np, head_table, device,
                                      HEAD_TABLE_LANES, (3,))),
        corner_cases=check_decode_corners(torch, device, {
            label: cdf.build_cdf_table(scales)
            for label, scales in corner_scale_tables().items()}))})
    emit({'rans_encode_checks': rans_encode_checks(torch, device)})
    emit({'tiled_core': check_core_synthetic(torch, device)})
    emit({'dw_tile': check_dw_synthetic(torch, device)})
    emit({'emb_zadd': check_emb_zadd_synthetic(torch, device)})
    emit({'nll_zadd': check_nll_zadd_synthetic(torch, device)})
    emit({'shuffle': check_shuffle_synthetic(torch, device)})

    t = time.perf_counter()
    model = lvae_tpu_torch.get_model('qarv_base', pretrained=CHECKPOINT)
    model.compress_mode(num_lanes='auto')
    load_s = time.perf_counter() - t
    progress(f'qarv_base loaded ({model.num_params()} params) in '
             f'{load_s:.1f} s')
    with tempfile.TemporaryDirectory() as tmpdir:
        legacy = run_codec(torch, model, False,
                           [(PHOTO, lmb) for lmb in LAMBDAS], tmpdir)
        portable = run_codec(torch, model, True,
                             [(PHOTO, lmb) for lmb in LAMBDAS]
                             + [(HOPPER, 512.0)], tmpdir)
        for row in portable:
            require(row['image'] != os.path.relpath(PHOTO, ROOT)
                    or row['lanes'] == lanes_of[row['lmb']],
                    'the codec ran at a lane count the rANS check did not '
                    'cover')
        emit({'codec': dict(model='qarv_base',
                            weights=os.path.relpath(CHECKPOINT, ROOT),
                            load_s=load_s, num_lanes='auto',
                            results=[{k: v for k, v in r.items()
                                      if k != 'path'}
                                     for r in legacy + portable])})
        main_lmb = max(LAMBDAS)

        def capture(path, lmb):
            im = coding.read_png(path).astype(np.float32)[None] / 255
            return (lambda: model.compress(im, lmb=lmb, portable=True),
                    model.decompress)

        trunk = check_trunk_kernels(torch, QARV_TRUNK, [
            ('photo1', *capture(PHOTO, main_lmb)),
            ('hopper', *capture(HOPPER, 512.0))])
        # upsample_finish against its chain also on photo1's inputs at the
        # other lambdas
        trunk['upsample_finish']['held_at'] = hold_redesigns(
            torch, ('upsample_finish',), [
                (f'photo1 lambda {lmb:g}', *capture(PHOTO, lmb))
                for lmb in LAMBDAS if lmb != main_lmb])['upsample_finish']
        emit({'trunk': trunk})
        batch, batch_launches, fresh_batch = run_batch(torch, model, tmpdir)
        emit({'batch': batch})
        photo512 = next(r for r in portable if r['lmb'] == 512.0
                        and r['image'] == os.path.relpath(PHOTO, ROOT))
        _, rec512 = model.compress_check(
            coding.read_png(PHOTO).astype(np.float32)[None] / 255.0,
            lmb=512.0, portable=True)
        qres, qres_launches, qres_kernels, fresh_qres, qres_state = \
            run_qres(torch, tmpdir)
        emit({'qres': qres})
        emit({'qres_trunk': qres_kernels})
        (lossless, lossless_launches, lossless_kernels, fresh_lossless,
         lossless_state) = run_lossless(torch, tmpdir)
        emit({'lossless': lossless})
        emit({'lossless_trunk': lossless_kernels})
        # the golden streams an earlier commit wrote, with the default
        # weights (the lossless model's as saved after it was built)
        model.compress_mode(num_lanes='auto', portable=True)
        golden_lossless = lvae_tpu_torch.get_model('qres34m_lossless')
        golden_lossless.net.load_state_dict(torch.load(
            lossless_state, map_location='cuda', weights_only=True))
        golden_lossless.compress_mode(portable=True, num_lanes=QRES_LANES,
                                      esc_cap=LOSSLESS_ESC_CAP)
        emit({'golden': check_golden(torch, {
            'qarv_base': model, 'qres34m_lossless': golden_lossless}, card)})
        del golden_lossless
        bf16, fresh_bf16 = run_bf16_codec(torch, model, qres_state, tmpdir)
        fresh = fresh_process_decode(
            [('photo1 file, lambda 512', 'qarv', photo512['path'], rec512),
             fresh_batch, fresh_qres, fresh_lossless] + fresh_bf16, tmpdir,
            dict(qres=qres_state, lossless=lossless_state))
        emit({'fresh_process': fresh})
        bf16['fresh_process_bitwise'] = {
            r['file']: r['bitwise_equal'] for r in fresh['files']
            if 'bf16' in r['file']}
        emit({'bf16_codec': bf16})
        emit({'eval': run_eval(torch, model, tmpdir)})
        host_coder, device_coder = run_staged(torch, model)
        emit({'host_coder': host_coder})
        emit({'device_coder': device_coder})
        qres17m = run_qres17m(torch, tmpdir)
        emit({'qres17m': qres17m})
        with exact_f32():
            emit({'rd': run_rd(torch, tmpdir)})
            emit({'sampling': run_sampling(torch, model, tmpdir)})
            emit({'torch_checkpoint': run_torch_checkpoint(torch, model,
                                                           tmpdir)})
        # the trainer sets exact float32 (and restores the flags) itself
        dp_nccl1, train = run_train(torch, tmpdir)
        emit({'train': train})
        where = dict(card=card['name'], power_limit=card['power_limit'])
        emit({'dp_nccl1': dict(dp_nccl1, **where)})
        gc_cuda(torch)
        t = time.perf_counter()
        dist_rows = run_distributed(tmpdir)
        for phase in DIST_PHASES:
            emit({phase: dict(dist_rows[phase], **where, backend='gloo',
                              world_size=DIST_RANKS, device='cuda:0')})
        emit({'nccl_two_ranks': dict(dist_rows['nccl_two_ranks'], **where,
                                     backend='nccl', world_size=2,
                                     device='cuda:0')})
        dist_seconds = dict(
            dp_nccl1=dp_nccl1['seconds'],
            **{p: dist_rows[p]['seconds'] for p in DIST_PHASES},
            torchrun_launch=dist_rows['launch_seconds'],
            nccl_two_ranks=dist_rows['nccl_two_ranks']['seconds'],
            multi_gpu_total=dp_nccl1['seconds'] + time.perf_counter() - t)

    # one entry per kernel. The single-image kernels and the trunk's: one
    # photo1 image at the largest lambda on the file path (portable files),
    # its launches in that image's compress_file + decompress_file and the
    # time of those launches. The multi-image kernels: the B = 6 request of
    # the batch path, its launches in compress_batch + decompress_batch and
    # the multi-kernel phase's times at B = 6, N = 128.
    main_row = next(r for r in portable if r['lmb'] == main_lmb)
    launches = {n: main_row['encode_launches'][n]
                + main_row['decode_launches'][n] for n in _NONE}
    for name in ('rans_encode_all_multi', 'rans_decode_block_multi'):
        require(launches[name] == 0, f'the file path launched {name}')
        launches[name] = batch_launches[name]
    for name in QRES_TRUNK:
        require(launches[name] == 0, f'the qarv file path launched {name}')
        launches[name] = qres_launches[name]
    for name in LOSSLESS_HEAD:
        require(launches[name] == 0 and qres_launches[name] == 0,
                f'a lossy file path launched {name}')
        launches[name] = lossless_launches[name]
    for name in OFF_PATH:
        require(launches[name] == qres_launches[name]
                == lossless_launches[name] == 0,
                f'{name}, an oracle, was launched on a main path')
    require(all(v > 0 for n, v in launches.items() if n not in OFF_PATH),
            f'a kernel was not launched on its main path: {launches}')
    rans_sources = {
        'rans_encode_all': 'lvae_tpu/ops/pallas/rans_encode.py:217',
        'rans_decode_block': 'lvae_tpu/ops/pallas/rans_decode.py:160',
        'rans_encode_all_multi': 'lvae_tpu/ops/pallas/rans_encode.py:419',
        'rans_decode_block_multi': 'lvae_tpu/ops/pallas/rans_decode.py:359'}
    trunk_sources = {
        'emb_mlp': 'lvae_tpu/ops/pallas/trunk.py:122',
        'dw_ln_mod': 'lvae_tpu/ops/pallas/trunk.py:166',
        'mlp_res': 'lvae_tpu/ops/pallas/trunk.py:223',
        'dense': 'lvae_tpu/ops/pallas/trunk.py:257',
        'prior_head': 'lvae_tpu/ops/pallas/trunk.py:302',
        'fuse_zproj': 'lvae_tpu/ops/pallas/trunk.py:343',
        'finish_image': 'lvae_tpu/ops/pallas/trunk.py:382',
        'upsample_finish': 'lvae_tpu/ops/pallas/trunk.py:257 + :382',
        'upsample_head': 'lvae_tpu/ops/pallas/trunk.py:257, twice',
        'dw_ln_affine': 'lvae_tpu/ops/pallas/trunk.py:462',
        'dense_act': 'lvae_tpu/ops/pallas/trunk.py:520',
        'conv_kxk_act': 'lvae_tpu/ops/pallas/trunk.py:563',
        'zadd_dense': 'lvae_tpu/ops/pallas/trunk.py:609',
        'zadd': 'lvae_tpu/ops/pallas/trunk.py:636',
        'zadd_conv_kxk': 'lvae_tpu/ops/pallas/trunk.py:636 + :563',
        'res_dense_act': 'lvae_tpu/ops/pallas/trunk.py:663',
        'nll_head': 'lvae_tpu/ops/pallas/trunk.py:767',
        'nll_recon': 'lvae_tpu/ops/pallas/trunk.py:807'}
    unit = f'one photo1 image (lambda {main_lmb:g}), compress_file + ' \
           f'decompress_file'
    # the rANS kernels' paths beside the fused codecs': the device coder's
    # decode (kernel #1) and qres17m's legacy fused codec (#1-#4), per
    # photo1 image (B = 2: photo1 and photo2), with each path's card time
    # and bound over its launches (rans_path_row)
    dev = device_coder['results']
    new_paths = {
        'rans_decode_block': {
            f'device coder decode, qarv_base photo1 lambda {STAGED_LMB:g}':
                dev['qarv_base']['rans_decode_block'],
            'device coder decode, qres34m photo1':
                dev['qres34m']['rans_decode_block'],
            'qres17m legacy fused decompress, photo1':
                qres17m['rans_paths']['rans_decode_block']},
        'rans_encode_all': {
            'qres17m legacy fused compress, photo1':
                qres17m['rans_paths']['rans_encode_all']},
        'rans_decode_block_multi': {
            'qres17m legacy fused decompress_batch, B = 2':
                qres17m['rans_paths']['rans_decode_block_multi']},
        'rans_encode_all_multi': {
            'qres17m legacy fused compress_batch, B = 2':
                qres17m['rans_paths']['rans_encode_all_multi']}}
    entries = []
    for name, by_n in rans.items():
        main_n = by_n[lanes_of[main_lmb]]
        entries.append(dict(
            name=name, route='cuda', source='lvae_tpu_torch/csrc/rans.cu',
            replaces=rans_sources[name], launches=launches[name],
            launches_encode=main_row['encode_launches'][name],
            launches_decode=main_row['decode_launches'][name],
            launches_unit=unit,
            match=all(r['match'] for r in by_n.values()),
            max_abs_err=max(r['max_abs_err'] for r in by_n.values()),
            ms=main_n['ms'], plain_ms=main_n['plain_ms'],
            **encode_oracle_keys(main_n),
            bound_ms=main_n['bound_ms'], bound_by=main_n['bound_by'],
            bound_derivation=(
                f'max(bytes / 3.35 TB/s, ops / 67 Tops/s) per qarv_base '
                f'512x768 image at N={lanes_of[main_lmb]}; the real limit '
                f'is the serial chain of T dependent rows (T at each N '
                f'below; the encode: chain_bound_ms)'),
            library_ms=None, new_paths=new_paths[name],
            by_lanes={str(n): r for n, r in by_n.items()}))
    batch_n = max(lanes_of.values())
    for name, by_case in multi.items():
        main_b = by_case[f'N{batch_n}_B{SERVING_B}']
        entries.append(dict(
            name=name, route='cuda', source='lvae_tpu_torch/csrc/rans.cu',
            replaces=rans_sources[name], launches=launches[name],
            launches_encode=batch['encode_launches'][name],
            launches_decode=batch['decode_launches'][name],
            launches_unit=f'one B = {SERVING_B} request (photo1..3 at lambda '
                          f'776.05 and 2048), compress_batch + '
                          f'decompress_batch',
            match=True,
            max_abs_err=max(r['max_abs_err'] for r in by_case.values()),
            ms=main_b['ms'], single_launches_ms=main_b['single_launches_ms'],
            plain_ms=main_b['plain_ms'], **encode_oracle_keys(main_b),
            bound_ms=main_b['bound_ms'], bound_by=main_b['bound_by'],
            bound_derivation=(
                f'max(bytes / 3.35 TB/s, ops / 67 Tops/s) for {SERVING_B} '
                f'qarv_base 512x768 images at N={batch_n}; the real limit is '
                f'the serial chain of T dependent rows of one image'),
            library_ms=None, new_paths=new_paths[name],
            by_case=by_case))
    qres_unit = (f'one photo1 image, qres34m (random weights, N = '
                 f'{QRES_LANES}), compress_file + decompress_file')
    lossless_unit = qres_unit.replace('qres34m', 'qres34m_lossless')
    for name in TRUNK_NAMES:
        if name in QRES_TRUNK:
            r, res, row_unit = qres_kernels[name], qres, qres_unit
        elif name in LOSSLESS_HEAD:
            r, res, row_unit = (lossless_kernels[name], lossless,
                                lossless_unit)
        else:
            r, res, row_unit = trunk[name], None, unit
        enc, dec = ((res['file_encode_launches'],
                     res['file_decode_launches']) if res
                    else (main_row['encode_launches'],
                          main_row['decode_launches']))
        entries.append(dict(
            name=name, route='cuda', source='lvae_tpu_torch/csrc/trunk.cu',
            replaces=trunk_sources[name], launches=launches[name],
            launches_encode=enc[name], launches_decode=dec[name],
            launches_unit=row_unit,
            max_abs_err=r['max_abs_err'],
            index_flips=(r['index_flips'] if name in ('prior_head',
                                                      'nll_head') else None),
            tolerance=('bitwise' if name in LOSSLESS_TRUNK
                       else f'atol {TRUNK_ATOL:g} + rtol {TRUNK_RTOL:g}'
                       + (' + one float16 ulp (2^-11)'
                          if name == 'upsample_finish' else '')),
            ms=r['ms'], encode_ms=r['encode_ms'], decode_ms=r['decode_ms'],
            eager_ms=r['eager_ms'],
            **{k: r[k] for k in ('old_core_ms', 'product_ms',
                                 'staged_gelu_ms', 'kernel_ms_where_staged',
                                 'prepass_ms', 'addmm_ms', 'oracle_ms',
                                 'oracle_bitwise_shapes',
                                 'oracle_max_abs_err', 'cluster8_ms',
                                 'conv_alone_ms', 'search_library_ms',
                                 'held_at')
               if k in r},
            **({'oracle': {'emb_mlp': 'emb_mlp_oneblock (one block a row)',
                           'zadd_conv_kxk': 'zadd, then conv_kxk_act('
                                            'act=False)',
                           'nll_head': 'nll_head_linear (the count over all '
                                       'S entries)',
                           'upsample_finish': 'upsample_finish_chain: dense, '
                                              'pixel_shuffle_nhwc(...)'
                                              '.contiguous(), finish_image, '
                                              '.to(float16)',
                           'upsample_head': 'upsample_head_chain: two dense '
                                            'launches, two '
                                            'pixel_shuffle_nhwc(...)'
                                            '.contiguous()'}[name]}
               if name in REDESIGN_ORACLES else {}),
            **({'search_library': 'torch.searchsorted(table[:-1], '
                                  'scales), the scales computed beforehand: '
                                  'the index count alone'}
               if 'search_library_ms' in r else {}),
            **({'addmm': 'torch.addmm(feature, a, w), TF32 off, a = '
                         + ('syms.float() + pm' if name == 'fuse_zproj'
                            else 'the plain _gelu(t)')
                         + ' computed beforehand: without the bias and the '
                           'prologue'}
               if 'addmm_ms' in r else {}),
            **(dict(warp_oracle_ms=r['warp_oracle_ms'],
                    two_calls_ms=r['two_calls_ms'],
                    two_calls='F.conv2d(groups=C) + F.layer_norm, TF32 off'
                              + ('' if name == 'dw_ln_affine'
                                 else ', without the modulation'))
               if name in DW_NAMES else {}),
            plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
            bound_by=r['bound_by'],
            bound_derivation=(
                'max(sum of bytes / 3.35 TB/s, sum of f32 ops / 67 TFLOP/s) '
                'over the launches of one image (each input read once, '
                'each output written once)'),
            library_ms=r['library_ms'],
            library_call=LIBRARY_CALLS.get(name),
            library_launches=r['library_launches'],
            kernel_ms_where_library=r['kernel_ms_where_library']))
    # the oracles off the main path, on the inputs of the main-path calls
    # they replaced, as often: emb_mlp's one-block kernel (plain_ms and
    # bound_ms: the same function on the same inputs as emb_mlp's), and zadd
    # on zadd_conv_kxk's (syms, pm)
    emb = trunk['emb_mlp']
    entries.append(dict(
        name='emb_mlp_oneblock', route='cuda',
        source='lvae_tpu_torch/csrc/trunk.cu',
        replaces=trunk_sources['emb_mlp'], launches=0, on_main_path=False,
        oracle_of='emb_mlp', timed_on="the inputs of emb_mlp's calls, as "
                                      "often", launches_unit=unit,
        max_abs_err=emb['oracle_max_abs_err'],
        tolerance=f'atol {TRUNK_ATOL:g} + rtol {TRUNK_RTOL:g}',
        ms=emb['oracle_ms'], plain_ms=emb['plain_ms'],
        bound_ms=emb['bound_ms'], bound_by=emb['bound_by'],
        library_ms=None))
    za = qres_kernels['zadd_conv_kxk']['zadd']
    entries.append(dict(
        name='zadd', route='cuda', source='lvae_tpu_torch/csrc/trunk.cu',
        replaces=trunk_sources['zadd'], launches=launches['zadd'],
        launches_encode=0, launches_decode=0, on_main_path=False,
        oracle_of='zadd_conv_kxk', timed_on="the (syms, pm) of "
                                            "zadd_conv_kxk's calls, as often",
        calls_timed=za['calls'], launches_unit=qres_unit,
        max_abs_err=za['max_abs_err'],
        tolerance=f'atol {TRUNK_ATOL:g} + rtol {TRUNK_RTOL:g}',
        ms=za['ms'], plain_ms=za['plain_ms'], bound_ms=za['bound_ms'],
        bound_by=za['bound_by'], library_ms=za['library_ms'],
        library_call=LIBRARY_CALLS['zadd']))
    fin = trunk['upsample_finish']['finish_image']
    entries.append(dict(
        name='finish_image', route='cuda',
        source='lvae_tpu_torch/csrc/trunk.cu',
        replaces=trunk_sources['finish_image'],
        launches=launches['finish_image'], launches_encode=0,
        launches_decode=0, on_main_path=False, oracle_of='upsample_finish',
        timed_on="the shuffled conv outputs of upsample_finish's calls, as "
                 "often", calls_timed=fin['calls'], launches_unit=unit,
        max_abs_err=fin['max_abs_err'], tolerance='bitwise',
        ms=fin['ms'], plain_ms=fin['plain_ms'], bound_ms=fin['bound_ms'],
        bound_by=fin['bound_by'], library_ms=None))
    emit({'seconds': dict(build=info['seconds'], **dist_seconds,
                          total=elapsed())})
    print(smi, flush=True)
    emit({'kernels': entries})
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(rank_phases(sys.argv[2]) if sys.argv[1:2] == ['--rank-phases']
             else main())
