"""The trainer, counterpart of ``lvae_tpu/training/trainer.py``
(BaseTrainingWrapper): `TrainWrapper(cfg, device).main()`, with the
subclass hooks set_dataset() and eval_model(). One process a device; under
torchrun (`python -m torch.distributed.run --nproc_per_node=N -m
lvae_tpu_torch.train_var_rate ...`) data parallel over the ranks:

  * the LR schedule every 10 steps, the EMA decay ema_decay * (1 -
    exp(-step / warmup)) and the moving grad-norm median, computed on the
    host and passed into the step (training/optim.py)
  * step N's metrics are pulled after step N+1 is issued: their copy to the
    host starts right after step N is issued and is waited for one step
    later, so the host never waits for the device's current step
  * checkpoints last / best / last_ema / best_ema (+ failed on abort)
  * a streak of 20 skipped steps (non-finite loss or grad norm) aborts
    with the failed dump
  * --amp runs the forward in bf16 (compute_dtype='bfloat16'), --remat
    checkpoints every block, --device_data keeps the training set on the
    card (datasets/device_cache.py)
  * the step's operations from torch.utils.flop_counter's count of its
    forward (_count_step_flops), and --probe_device_step times the step
    alone with CUDA events
  * data parallel: parallel/mesh.init_distributed picks the rank's device
    (cuda:LOCAL_RANK unless --device says otherwise) and joins the group;
    each loader draws the rank's shard; the state is checked equal across
    ranks after it is built or read and taken from rank 0; the step
    averages gradients and stats over the ranks (training/optim.py), so
    every rank skips, cuts and aborts on the same step; rank 0 alone
    writes the run directory, logs, evaluates and checkpoints; the noise
    seed is 2 + rank, as in the JAX trainer

Training runs under models/base.exact_f32() (no TF32, deterministic cuDNN
algorithms), so that the card and the CPU compute the same float32
function; the process's flags are restored when main() returns.

Differences from the JAX trainer, for a resume that continues the
uninterrupted run: each step's noise comes from a generator seeded by
(seed, step), the loader starts at the resumed step's batch, the LR is the
one of the last step divisible by 10, and the grad-norm buffer is saved in
the checkpoint.
"""
import json
import logging
import math
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from lvae_tpu_torch.datasets.loader import make_trainloader
from lvae_tpu_torch.datasets.image import parse_transform_cfg
from lvae_tpu_torch.models.base import exact_f32
from lvae_tpu_torch.parallel import dist_utils
from lvae_tpu_torch.parallel import mesh as pmesh
from lvae_tpu_torch.registry import get_model
from lvae_tpu_torch.training import checkpoint as ckpt
from lvae_tpu_torch.training.optim import TrainState, make_train_step
from lvae_tpu_torch.training.schedules import lr_factor
from lvae_tpu_torch.utils import general as utils

__all__ = ['BaseTrainingWrapper']

# dense peaks of one NVIDIA H100 (SXM, the data sheet): float32 outside the
# tensor cores, and bf16
PEAK_FLOPS = {'float32': 67e12, 'bfloat16': 989e12}
NONFINITE_ABORT = 20                  # consecutive skipped steps


def step_seed(seed, step):
    """The seed of a step's noise generator."""
    return (seed * 1_000_003 + step) % (1 << 63)


class BaseTrainingWrapper:
    grad_norm_interval = 100

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = pmesh.init_distributed(device=device)
        self.world_size = pmesh.process_count()
        self.local_rank = pmesh.process_index()
        self.distributed = self.world_size > 1
        self.is_main = self.local_rank == 0
        # a process group of one (torchrun --nproc_per_node=1) still runs
        # the step's collectives
        self.mesh = pmesh.get_data_mesh() if dist.is_initialized() else None
        self._cur_iter = 0
        self._cur_epoch = 0.0
        self._best_loss = math.inf
        self._nonfinite_streak = 0
        self._moving_grad_norm_buffer = utils.MaxLengthList(
            max_len=self.grad_norm_interval)
        self.wandb_log_keys = set()
        header = ['Epoch', 'Iter', 'Mem', 'lr', 'grad', 'img/s', 'MFU%']
        self.stats_table = utils.SimpleTable(header)
        self._step_flops = None
        self._step_dt_ema = None
        self._device_step_ms = None
        self.step_peak_bytes = None
        self._results = {}
        self.wbrun = None
        # per step, as consumed: {'step', 'loss', 'grad_norm', 'seconds'}
        self.history = []

    # ------------------------------------------------------------------ setup
    def main(self):
        with exact_f32():
            self.set_logging()
            self.prepare_configs()
            self.set_dataset()
            self.set_model()
            self.set_optimizer()
            self.set_pretrain()
            self.sync_state()
            self.set_wandb()
            self.training_loops()
        return self

    def set_logging(self):
        cfg = self.cfg
        logging.basicConfig(handlers=[utils.my_stream_handler()],
                            level=logging.INFO if self.is_main
                            else logging.WARNING, force=True)
        log_parent = Path(f'runs/{cfg.wbproject}').resolve()
        if cfg.resume is not None:
            log_dir = log_parent / str(cfg.resume)
            if not log_dir.is_dir():
                raise FileNotFoundError(
                    f'Cannot resume: {log_dir} does not exist')
        elif self.is_main:
            run_name = cfg.name or utils.increment_dir(log_parent,
                                                       name=cfg.model)
            log_dir = log_parent / str(run_name)
            os.makedirs(log_dir, exist_ok=False)
            utils.json_dump(vars(cfg), fpath=log_dir / 'config.json')
        # every rank reads the run directory rank 0 made (for a resume, its
        # checkpoint), and writes nothing there
        log_dir = Path(dist_utils.broadcast_object(
            str(log_dir) if self.is_main else None))
        logging.info(f'Logging run at {log_dir}')
        self.cfg.log_dir = str(log_dir)
        self._log_dir = log_dir

    def prepare_configs(self):
        cfg = self.cfg
        bs_effective = cfg.batch_size * self.world_size * cfg.accum_num
        logging.info(f'Batch size = {cfg.batch_size}; effective = '
                     f'{bs_effective}; lr = {cfg.lr}; wdecay = {cfg.wdecay}; '
                     f'device = {self.device}; world size = '
                     f'{self.world_size}')
        cfg.bs_effective = bs_effective
        cfg.world_size = self.world_size
        self._log_ema_weight = 5.0 / (cfg.wandb_log_interval + 8.0)

    def set_dataset(self):
        raise NotImplementedError()

    def make_training_loader(self, dataset):
        """Take the training set; its loader starts in training_loops, at
        the batch of the step the run starts from."""
        cfg = self.cfg
        if hasattr(dataset, 'out_dtype'):
            # raw uint8 batches: the loss normalises on the device
            dataset.out_dtype = np.dtype(np.uint8)
        self._trainset = dataset
        self._data_seed = 2 if cfg.fixseed else int(time.time())
        self._epoch_len = len(dataset) / cfg.bs_effective
        self.cfg.epochs = float(cfg.iterations / self._epoch_len)

    def _start_loader(self, start_batch):
        cfg, dataset = self.cfg, self._trainset
        if getattr(cfg, 'device_data', False):
            from lvae_tpu_torch.datasets.device_cache import DeviceDataLoader
            loader = DeviceDataLoader(
                dataset, batch_size=cfg.batch_size, device=self.device,
                num_shards=self.world_size, shard_id=self.local_rank,
                seed=self._data_seed, start_batch=start_batch)
            logging.info(f'device data cache: {len(dataset)} images '
                         f'({loader.images.numel() / 1e9:.2f} GB on the '
                         f'device); per-step host-to-device traffic is the '
                         f'augmentation parameters only')
            self.trainsampler = loader.sampler
        else:
            loader, self.trainsampler = make_trainloader(
                dataset, batch_size=cfg.batch_size, workers=cfg.workers,
                num_shards=self.world_size, shard_id=self.local_rank,
                seed=self._data_seed, start_batch=start_batch)
        self.trainloader = loader

    def _next_batch(self):
        """The next batch on the device (uint8 NHWC)."""
        b = next(self.trainloader)
        if torch.is_tensor(b):
            return b
        b = torch.from_numpy(b)
        if self.device.type == 'cuda':
            b = b.pin_memory()
        return b.to(self.device, non_blocking=True)

    def set_model(self):
        cfg = self.cfg
        kwargs = parse_transform_cfg(cfg.model_args)   # 'lmb=2048,...'
        # a model without weights starts from the same random weights in
        # every --fixseed run (the JAX package's init draws from seed 0)
        with torch.random.fork_rng(devices=[]):
            if cfg.fixseed:
                torch.manual_seed(0)
            model = get_model(cfg.model, device=self.device, **kwargs)
        cfg.num_param = model.num_params()
        logging.info(f'Model {cfg.model}, args={kwargs}, '
                     f'{cfg.num_param / 1e6:.2f}M params')
        if self.is_main:
            utils.print_to_file(str(model.net),
                                fpath=self._log_dir / 'model.txt')
        self.model = model

    def set_optimizer(self):
        cfg = self.cfg
        self.state = TrainState(self.model.net, optimizer=cfg.optimizer,
                                ema=cfg.ema)
        groups = {'weights': [], 'bias': [], 'other': []}
        for name, p in zip(self.state.names, self.state.params):
            groups[self.state.groups[name]].append(
                f'{name:<80s} {tuple(p.shape)}')
        groups['groups'] = [
            f'weights: lr={cfg.lr}, weight_decay={cfg.wdecay}',
            f'bias:    lr={cfg.lr}, weight_decay=0.0',
            f'other:   lr={cfg.lr}, weight_decay=0.0',
        ]
        if self.is_main:
            utils.json_dump(groups, fpath=self._log_dir / 'optimizer.json')
        logging.info('optimizer parameter groups: ' + ', '.join(
            f'[{k}: {len(v)}]' for k, v in groups.items()))

        self.compute_dtype = 'bfloat16' if getattr(cfg, 'amp', False) \
            else None
        remat = bool(getattr(cfg, 'remat', False))

        def loss_fn(batch, generator):
            im = batch.permute(0, 3, 1, 2).float().div(255.0)
            return self.model.loss_and_stats(
                im.contiguous(), training=True, generator=generator,
                compute_dtype=self.compute_dtype, remat=remat)

        self._loss_fn = loss_fn
        self.peak_flops = self._peak_flops_of()
        self._train_step = make_train_step(
            loss_fn, self.state, accum_num=cfg.accum_num,
            grad_clip=cfg.grad_clip, wdecay=cfg.wdecay, use_ema=cfg.ema,
            mesh=self.mesh)

    def set_pretrain(self):
        cfg = self.cfg
        if cfg.resume is not None:
            if cfg.weights:
                raise ValueError('--resume is incompatible with --weights')
            path = self._log_dir / 'last'
            restored = ckpt.load_checkpoint(path)
            self.state.load_state_dict(restored['state'])
            self._cur_iter = int(restored['iter'])
            self._cur_epoch = float(restored['epoch'])
            self._best_loss = float(restored['best_loss'])
            for v in restored['grad_norms']:
                self._moving_grad_norm_buffer.add(v)
            logging.info(f'Resumed from {path} at iter {self._cur_iter}')
        elif cfg.weights is not None:
            restored = ckpt.load_checkpoint(cfg.weights) \
                if getattr(cfg, 'load_optim', False) else None
            if restored is not None and 'state' in restored:
                # warm start with the optimizer's state, this run's counts
                self.state.load_state_dict(restored['state'], counts=False)
            else:
                self.model.load_weights(cfg.weights)
                if self.state.ema is not None:
                    with torch.no_grad():
                        self.state.ema.copy_(self.state.flat)
            logging.info(f'Initialized weights from {cfg.weights} '
                         f'(load_optim={getattr(cfg, "load_optim", False)})')
        else:
            logging.info('Training from scratch (no pretrained weights).')

    def sync_state(self):
        """Every rank takes rank 0's state. A state read from a file
        (--resume, --weights) must already be equal on every rank; a
        random start that is not (a run without --fixseed) is logged."""
        if not self.distributed:
            return
        same = dist_utils.check_model_equivalence(self.state, self.mesh)
        if not same and (self.cfg.resume is not None
                         or self.cfg.weights is not None):
            raise RuntimeError('the state read from the checkpoint differs '
                               'across ranks')
        if not same:
            logging.warning('the random start differs across ranks; rank '
                            "0's is taken")
        pmesh.replicate(self.state, self.mesh)

    def set_wandb(self):
        cfg = self.cfg
        if getattr(cfg, 'wbmode', 'disabled') == 'disabled' \
                or not self.is_main:
            return
        try:
            import wandb
        except ImportError:
            logging.warning('wandb not installed; logging disabled')
            return
        wbid_path = self._log_dir / 'wandb_id.txt'
        rid = None
        if wbid_path.is_file():
            rid = utils.read_file(wbid_path).strip().split('\n')[-1]
        run_name = self._log_dir.stem
        if cfg.wbnote:
            run_name = f'{run_name}: {cfg.wbnote}'
        self.wbrun = wandb.init(
            project=cfg.wbproject, entity=cfg.wbentity, group=cfg.wbgroup,
            name=run_name, tags=cfg.wbtags, config=vars(cfg), dir='runs/',
            id=rid, resume='allow', mode=cfg.wbmode)
        utils.print_to_file(self.wbrun.id, fpath=wbid_path, mode='a')

    # ----------------------------------------------- operations and device time
    def _peak_flops_of(self):
        """The card's dense peak for the compute dtype; NaN off an H100."""
        if self.device.type != 'cuda' or \
                'H100' not in torch.cuda.get_device_name(self.device):
            return float('nan')
        return PEAK_FLOPS[self.compute_dtype or 'float32']

    def _count_step_flops(self, batch):
        """The operations of one step: its forward's convolutions and
        products (torch.utils.flop_counter, 2 per multiply-add, on a
        throwaway generator) times 3, times 4 with --remat (the backward
        of each costs two forwards: the input's and the weight's gradients;
        remat recomputes the forward once). FlopCounterMode's own count of
        a backward takes a grouped convolution as dense, C times too many
        operations for a depthwise one, so the backward is not counted.
        The state is not updated."""
        from torch.utils.flop_counter import FlopCounterMode
        g = torch.Generator(self.device).manual_seed(0)
        with FlopCounterMode(display=False) as counter:
            self._loss_fn(batch, g)
        passes = 4 if getattr(self.cfg, 'remat', False) else 3
        return float(counter.get_total_flops()) * passes

    def _probe_device_step(self, batch, k=3):
        """The step's device time alone (CUDA events, median of k after a
        warm-up) and the peak of allocated device memory over those steps
        (step_peak_bytes), on a copy of the state that is restored
        afterwards; no data loading and no metric pulls."""
        st = self.state
        saved = [t.clone() for t in st.flat_buffers().values()]
        counts = (st.count, st.accum_count, st.step)
        args = (1e-9, 1e9, 0.5)
        g = torch.Generator(self.device).manual_seed(0)
        self._train_step(batch, g, *args)                   # warm-up
        torch.cuda.synchronize(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        times = []
        for _ in range(k):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            self._train_step(batch, g, *args)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        # less the copy kept for the restore, which a run does not hold
        self.step_peak_bytes = torch.cuda.max_memory_allocated(
            self.device) - sum(t.numel() * t.element_size() for t in saved)
        with torch.no_grad():
            for t, s in zip(st.flat_buffers().values(), saved):
                t.copy_(s)
        st.count, st.accum_count, st.step = counts
        self._device_step_ms = float(np.median(times))
        self._device_mfu = self._step_flops / (self._device_step_ms / 1e3) \
            / self.peak_flops
        logging.info(f'device-only step: {self._device_step_ms:.1f} ms '
                     f'(device MFU {self._device_mfu * 100:.1f}%)')

    # ------------------------------------------------------------- main loop
    def training_loops(self):
        cfg = self.cfg
        pbar = range(self._cur_iter, cfg.iterations)
        if self.is_main:
            try:
                from tqdm import tqdm
                pbar = tqdm(pbar)
            except ImportError:
                pass
            self.init_progress_table()
        seed = 2 + self.local_rank if cfg.fixseed else int(time.time())
        gen = torch.Generator(self.device)
        # the LR of the last step the schedule was read at (every 10)
        lr_step = self._cur_iter - self._cur_iter % 10
        lr_now = cfg.lr * lr_factor(lr_step, cfg.iterations, cfg.lr_sched,
                                    cfg.lr_warmup, cfg.lrf_min)
        on_card = self.device.type == 'cuda'
        self._start_loader(self._cur_iter)
        self._t_prev = None
        pending = None                       # (step, staged metrics, lr)

        def stage_metrics(metrics):
            # the copy to the host starts now and is waited for one step
            # later, after the next step is issued
            keys = sorted(metrics)
            packed = torch.stack([metrics[k].float() for k in keys])
            if not on_card:
                return keys, packed, None
            host = torch.empty(packed.shape, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return keys, host, done

        def consume(p):
            step_p, (keys, host, done), lr_p = p
            if done is not None:
                done.synchronize()
            metrics = dict(zip(keys, host.tolist()))
            t_now = time.perf_counter()
            dt = None
            if self._t_prev is not None:
                dt = t_now - self._t_prev
                self._step_dt_ema = dt if self._step_dt_ema is None else \
                    0.9 * self._step_dt_ema + 0.1 * dt
            self._t_prev = t_now
            self.history.append(dict(step=step_p, loss=metrics['loss'],
                                     grad_norm=metrics['grad_norm'],
                                     seconds=dt))
            if math.isfinite(metrics['grad_norm']):
                self._moving_grad_norm_buffer.add(metrics['grad_norm'])
            if not (math.isfinite(metrics['loss'])
                    and math.isfinite(metrics['grad_norm'])):
                # the step skipped its update (non-finite grad norm) or its
                # loss is poisoned: a rare one is survivable, a streak means
                # the state is
                self._nonfinite_streak += 1
                logging.warning(
                    f'non-finite loss {metrics["loss"]} or grad norm '
                    f'{metrics["grad_norm"]} at step {step_p} '
                    f'({self._nonfinite_streak} consecutive)')
                if self._nonfinite_streak >= NONFINITE_ABORT:
                    logging.error(f'{self._nonfinite_streak} consecutive '
                                  f'non-finite steps at step {step_p}')
                    self.clean_and_exit()
            else:
                self._nonfinite_streak = 0
            if not self.is_main:
                return
            cur = self._cur_iter
            self._cur_iter = step_p          # log under the step's own index
            self.minibatch_log(pbar, metrics, lr_p)
            self.periodic_log()
            self._cur_iter = cur

        try:
            next_batch = None
            for step in pbar:
                self._cur_iter = step
                self._cur_epoch = step / self._epoch_len
                if cfg.model_val_interval > 0 \
                        and step % cfg.model_val_interval == 0 \
                        and (step > 0 or cfg.eval_first):
                    if pending is not None:      # drain the pipeline first
                        consume(pending)
                        pending = None
                    self.evaluate()
                    self._t_prev = None    # eval time must not count in img/s
                if step % 10 == 0:
                    lr_now = cfg.lr * lr_factor(step, cfg.iterations,
                                                cfg.lr_sched, cfg.lr_warmup,
                                                cfg.lrf_min)
                if next_batch is None:
                    next_batch = self._next_batch()
                batch = next_batch
                if self._step_flops is None:
                    self._step_flops = self._count_step_flops(batch)
                    logging.info(f'train step = {self._step_flops / 1e9:.1f}'
                                 f' GFLOP (3 or 4 forwards, flop_counter)')
                    if getattr(cfg, 'probe_device_step', False) and on_card:
                        self._probe_device_step(batch)
                    self._t_prev = None    # the first step pays warm-up
                median = self._moving_grad_norm_buffer.median() or 1e9
                warmup = cfg.ema_warmup or max(cfg.iterations // 20, 1)
                ema_decay = cfg.ema_decay * (1 - math.exp(-max(step, 1)
                                                          / warmup))
                gen.manual_seed(step_seed(seed, step))
                metrics = self._train_step(batch, gen, lr_now, median,
                                           ema_decay)
                staged = stage_metrics(metrics)
                # the next batch's copy is queued behind this step
                next_batch = self._next_batch()
                if pending is not None:
                    consume(pending)
                pending = (step, staged, lr_now)
            if pending is not None:
                consume(pending)
        finally:
            self.trainloader.stop()
        self._cur_iter += 1
        self.evaluate()
        logging.info(f'Training finished. results: {self._results}')

    # ------------------------------------------------------------- logging
    def init_progress_table(self):
        for k in self.stats_table.keys():
            self.stats_table[k] = 0.0
        self._pbar_header = self.stats_table.get_header(border=True)
        print(self._pbar_header)

    def memory_gb(self):
        """Peak device memory allocated so far (GB); 0 on the CPU."""
        if self.device.type != 'cuda':
            return 0.0
        return torch.cuda.max_memory_allocated(self.device) / 1e9

    def minibatch_log(self, pbar, metrics, lr_now):
        cfg = self.cfg
        self.stats_table['Epoch'] = f'{self._cur_epoch:.1f}/{cfg.epochs:.1f}'
        n = len(str(cfg.iterations))
        self.stats_table['Iter'] = f'{self._cur_iter:>{n}}/{cfg.iterations - 1}'
        self.stats_table['Mem'] = f'{self.memory_gb():.3g}G'
        self.stats_table['lr'] = lr_now
        self.stats_table['grad'] = self._moving_grad_norm_buffer.current()
        if self._step_dt_ema:
            imgs = cfg.batch_size * self.world_size / self._step_dt_ema
            self.stats_table['img/s'] = f'{imgs:.1f}'
            mfu = self._step_flops / self._step_dt_ema / self.peak_flops
            self.stats_table['MFU%'] = f'{100 * mfu:.1f}' \
                if mfu == mfu else 'n/a'
        for k, v in metrics.items():
            if k == 'grad_norm':
                continue
            prev = self.stats_table.get(k, 0.0)
            new = v if prev == 0.0 else \
                (1 - self._log_ema_weight) * prev + self._log_ema_weight * v
            self.stats_table[k] = new
            self.wandb_log_keys.add(k)
        header, body = self.stats_table.update(border=True)
        if len(header) != len(self._pbar_header):
            print(header)
            self._pbar_header = header
        if hasattr(pbar, 'set_description'):
            pbar.set_description(body)

    def periodic_log(self):
        cfg = self.cfg
        if self._cur_iter % cfg.wandb_log_interval == 0:
            # the loss curve in the run directory, one JSON line per interval
            rec = {'iter': self._cur_iter,
                   'lr': float(self.stats_table['lr']),
                   'grad_norm': self._moving_grad_norm_buffer.current()}
            for k in self.wandb_log_keys:
                rec[k] = float(self.stats_table[k])
            if self._step_dt_ema:
                rec['img_per_s'] = round(
                    cfg.batch_size * self.world_size / self._step_dt_ema, 2)
                mfu = self._step_flops / self._step_dt_ema / \
                    self.peak_flops
                if mfu == mfu:
                    rec['mfu'] = round(mfu, 4)
            if self._device_step_ms:
                rec['device_step_ms'] = round(self._device_step_ms, 2)
                if self._device_mfu == self._device_mfu:
                    rec['device_mfu'] = round(self._device_mfu, 4)
            with open(self._log_dir / 'train_log.jsonl', 'a') as f:
                f.write(json.dumps(rec) + '\n')
        if self._cur_iter % cfg.model_log_interval == 0 and \
                self._cur_iter > 0 and hasattr(self.model, 'study'):
            try:
                self.model.study(save_dir=self._log_dir)
            except Exception as e:   # logging must not end the training
                logging.warning(f'study() failed: {e!r}')
        if self.wbrun is not None and \
                self._cur_iter % cfg.wandb_log_interval == 0:
            log = {'general/lr': self.stats_table['lr'],
                   'general/grad_norm': self._moving_grad_norm_buffer.max()}
            log.update({'train/' + k: self.stats_table[k]
                        for k in self.wandb_log_keys})
            self.wbrun.log(log, step=self._cur_iter)

    # ------------------------------------------------------------- evaluation
    def eval_model(self, model) -> dict:
        raise NotImplementedError

    @torch.no_grad()
    def evaluate(self):
        """Evaluate the plain weights, then the EMA (swapped into the
        network and back), each followed by its checkpoints: on rank 0,
        while the other ranks wait."""
        if self.is_main:
            self._evaluate()
        dist_utils.barrier('evaluate')

    def _evaluate(self):
        cfg = self.cfg
        self._host_state = self.state.state_dict()
        results = self.eval_model(self.model)
        logging.info(f'Validation (no EMA): {results}')
        utils.print_dict_as_table(results)
        self._save_checkpoints(results, ema=False)
        if cfg.ema:
            flat = self.state.flat
            plain = flat.clone()
            flat.copy_(self.state.ema)
            try:
                results_ema = self.eval_model(self.model)
            finally:
                flat.copy_(plain)
            logging.info(f'Validation (EMA): {results_ema}')
            utils.print_dict_as_table(results_ema)
            self._save_checkpoints(results_ema, ema=True)
            results = results_ema
        self._host_state = None
        if self.wbrun is not None:
            self.wbrun.log({'val-metrics/' + k: v for k, v in results.items()
                            if isinstance(v, (int, float))},
                           step=self._cur_iter)
        with open(self._log_dir / 'results.txt', 'a') as f:
            f.write(self.stats_table.get_body()
                    + f' || {results.get("loss", 0):.6g}\n')
        self._results = results

    def _save_checkpoints(self, results, ema=False):
        payload = {'state': self._host_state, 'iter': self._cur_iter,
                   'epoch': self._cur_epoch,
                   'best_loss': min(self._best_loss,
                                    results.get('loss', math.inf)),
                   'grad_norms': list(self._moving_grad_norm_buffer._data)}
        last = self._log_dir / ('last_ema' if ema else 'last')
        ckpt.save_checkpoint(last, payload)
        cur_loss = results.get('loss', math.inf)
        if cur_loss < self._best_loss:
            self._best_loss = cur_loss
            # the same payload: linked, not written twice
            ckpt.copy_checkpoint(last, self._log_dir / ('best_ema' if ema
                                                       else 'best'))
            logging.info(f'New best loss = {cur_loss}')

    def clean_and_exit(self):
        """Every rank stops on the same step (the streak is decided from
        averaged stats); rank 0 writes the failed dump first."""
        logging.error(f'Terminating the run on rank {self.local_rank} ...')
        if self.is_main:
            ckpt.save_checkpoint(self._log_dir / 'failed',
                                 {'state': self.state.state_dict()})
        dist_utils.barrier('failed')
        raise SystemExit('Training terminated on non-finite steps.')
