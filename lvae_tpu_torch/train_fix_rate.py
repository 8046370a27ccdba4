"""Fixed-rate training CLI (QRes-VAE family), counterpart of
``train-fix-rate.py``: its arguments and defaults, one device. Validation
is the forward-only image_self_evaluate on --valset. Runs on the card;
--device cpu runs on the CPU:

    python -m lvae_tpu_torch.train_fix_rate --model qres_tiny \
        --model_args lmb=64 --trainset images --valset images \
        --transform crop=64,hflip=True --batch_size 4 --iterations 20 \
        --device cpu
"""
import argparse
import logging

from lvae_tpu_torch.datasets import get_image_dateset
from lvae_tpu_torch.evaluation import image_self_evaluate
from lvae_tpu_torch.paths import known_datasets
from lvae_tpu_torch.training.trainer import BaseTrainingWrapper

# (flag, type-or-action, default): train-fix-rate.py's schema, grouped
_SCHEMA = {
    'wandb': [
        ('wbproject', str, 'qres'),
        ('wbentity', str, None),
        ('wbgroup', str, 'fix-rate-exp'),
        ('wbtags', '+', None),
        ('wbnote', str, None),
        ('wbmode', str, 'disabled'),
        ('name', str, None),
    ],
    'model': [
        ('model', str, 'qres34m'),
        ('model_args', str, 'lmb=32'),
    ],
    'resume': [
        ('resume', str, None),
        ('weights', str, None),
        ('load_optim', 'bool', False),
    ],
    'data': [
        ('trainset', str, 'coco-train2017'),
        ('transform', str, 'crop=256,hflip=True'),
        ('valset', str, 'kodak'),
    ],
    'optimization': [
        ('batch_size', int, 16),
        ('accum_num', int, 1),
        ('optimizer', str, 'adam'),
        ('lr', float, 2e-4),
        ('lr_sched', str, 'constant'),
        ('lrf_min', float, 0.01),
        ('lr_warmup', int, 1000),
        ('grad_clip', float, 2.0),
        ('iterations', int, 800_000),
        ('eval_first', 'bool', False),
    ],
    'ema': [
        ('ema', 'bool', True),
        ('ema_decay', float, 0.9999),
        ('ema_warmup', int, 10_000),
    ],
    'runtime': [
        ('device', str, None),          # the card when unset; cpu
        ('fixseed', 'bool', True),
        ('amp', 'bool', False),         # bf16 compute of the forward
        ('remat', 'bool', False),       # per-block rematerialization
        ('workers', int, 6),
        ('data_cache', 'bool', False),  # decode the set once to a uint8 blob
        ('device_data', 'bool', False),  # the whole set on the card
        ('probe_device_step', 'bool', False),
        ('val_interval', int, 2000),
    ],
}

# fixed post-parse settings, as train-fix-rate.py's
_FIXED = dict(wdecay=0.0, wandb_log_interval=100, model_log_interval=2000)


def build_config(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    for group, entries in _SCHEMA.items():
        g = ap.add_argument_group(group)
        for flag, kind, default in entries:
            if kind == 'bool':
                g.add_argument(f'--{flag}', default=default,
                               action=argparse.BooleanOptionalAction)
            elif kind == '+':
                g.add_argument(f'--{flag}', type=str, nargs='+',
                               default=default)
            else:
                g.add_argument(f'--{flag}', type=kind, default=default)
    cfg = ap.parse_args(argv)
    for k, v in _FIXED.items():
        setattr(cfg, k, v)
    cfg.model_val_interval = cfg.val_interval
    return cfg


class FixRateTrainer(BaseTrainingWrapper):
    def set_dataset(self):
        cfg = self.cfg
        trainset = get_image_dateset(cfg.trainset, transform_cfg=cfg.transform,
                                     decode_cache=cfg.data_cache)
        self.make_training_loader(trainset)
        logging.info(f'train: {trainset.root} ({len(trainset)} images, '
                     f'{trainset.transform}); '
                     f'val: {known_datasets.get(cfg.valset, cfg.valset)}')

    def eval_model(self, model) -> dict:
        return image_self_evaluate(model, self.cfg.valset, progress=False)


def main(argv=None, device=None):
    """Train on argv (sys.argv when None) -> the finished FixRateTrainer.
    `device` overrides --device (tests pass 'cpu')."""
    cfg = build_config(argv)
    return FixRateTrainer(cfg, device or cfg.device).main()


if __name__ == '__main__':
    main()
