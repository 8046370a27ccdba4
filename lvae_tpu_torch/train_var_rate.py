"""Variable-rate training CLI (QARV and RD families), counterpart of
``train-var-rate.py``: its arguments and defaults, one device. Validation
is the model's forward-only lambda sweep (self_evaluate) on --valset, and
the model-selection loss is the BD-rate against the set's VTM 18.0 anchor
where the repository has one (results/<set>/<set>-vtm18.0.json), else the
middle lambda's loss. Runs on the card; --device cpu runs on the CPU:

    python -m lvae_tpu_torch.train_var_rate --model qarv_base \
        --weights checkpoints/qarv_base_mixed20k_ema_f16.msgpack \
        --trainset images --valset images --batch_size 16
"""
import argparse
import json
import logging
from pathlib import Path

from lvae_tpu_torch.datasets import get_image_dateset
from lvae_tpu_torch.paths import known_datasets
from lvae_tpu_torch.training.trainer import BaseTrainingWrapper
from lvae_tpu_torch.utils.coding import bd_rate

RESULTS = Path(__file__).resolve().parent.parent / 'results'
ANCHORS = {
    'kodak': 'kodak/kodak-vtm18.0.json',
    'tecnick-rgb-1200': 'tecnick-rgb-1200/tecnick-rgb-1200-vtm18.0.json',
    'clic2022-test': 'clic2022-test/clic2022-test-vtm18.0.json',
}


def build_config(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    bool_arg = argparse.BooleanOptionalAction
    # wandb setting
    parser.add_argument('--wbproject',  type=str, default='default')
    parser.add_argument('--wbentity',   type=str, default=None)
    parser.add_argument('--wbgroup',    type=str, default='var-rate-exp')
    parser.add_argument('--wbtags',     type=str, default=None, nargs='+')
    parser.add_argument('--wbnote',     type=str, default=None)
    parser.add_argument('--wbmode',     type=str, default='disabled')
    parser.add_argument('--name',       type=str, default=None)
    # model setting
    parser.add_argument('--model',      type=str, default='qarv_base')
    parser.add_argument('--model_args', type=str, default='')
    # resume setting
    parser.add_argument('--resume',     type=str, default=None)
    parser.add_argument('--weights',    type=str, default=None)
    parser.add_argument('--load_optim', action=bool_arg, default=False)
    # data setting
    parser.add_argument('--trainset',   type=str, default='coco-train2017')
    parser.add_argument('--transform',  type=str, default='crop=256,hflip=True')
    parser.add_argument('--valset',     type=str, default='kodak')
    parser.add_argument('--val_steps',  type=int, default=8)
    # optimization setting
    parser.add_argument('--batch_size', type=int, default=16)
    parser.add_argument('--accum_num',  type=int, default=1)
    parser.add_argument('--optimizer',  type=str, default='adam')
    parser.add_argument('--lr',         type=float, default=2e-4)
    parser.add_argument('--lr_sched',   type=str, default='const-0.5-cos')
    parser.add_argument('--lrf_min',    type=float, default=0.01)
    parser.add_argument('--lr_warmup',  type=int, default=0)
    parser.add_argument('--grad_clip',  type=float, default=2.0)
    # training iterations setting
    parser.add_argument('--iterations', type=int, default=2_000_000)
    parser.add_argument('--eval_first', action=bool_arg, default=False)
    # exponential moving averaging (EMA)
    parser.add_argument('--ema',        action=bool_arg, default=True)
    parser.add_argument('--ema_decay',  type=float, default=0.9999)
    parser.add_argument('--ema_warmup', type=int, default=10_000)
    # device setting
    parser.add_argument('--device',     type=str, default=None,
                        help='the card when unset; cpu to run on the CPU')
    parser.add_argument('--fixseed',    action=bool_arg, default=True)
    # bf16 compute of the forward (compute_dtype='bfloat16')
    parser.add_argument('--amp',        action=bool_arg, default=False)
    # per-block gradient rematerialization
    parser.add_argument('--remat',      action=bool_arg, default=False)
    parser.add_argument('--workers',    type=int, default=6)
    parser.add_argument('--data_cache', action=bool_arg, default=False)
    # the whole uint8 training set on the card
    parser.add_argument('--device_data', action=bool_arg, default=False)
    parser.add_argument('--probe_device_step', action=bool_arg,
                        default=False)
    parser.add_argument('--val_interval', type=int, default=2000)
    cfg = parser.parse_args(argv)

    cfg.wdecay = 0.0
    cfg.wandb_log_interval = 100
    cfg.model_log_interval = 2000
    cfg.model_val_interval = cfg.val_interval
    return cfg


def process_log_results(results, dataset_name='kodak'):
    """The BD-rate over the set's anchor (the middle lambda's loss when it
    has none) becomes results['loss']; -> the numbers to log."""
    try:
        with open(RESULTS / ANCHORS[dataset_name]) as f:
            anchor = json.load(f)
        anchor = anchor.get('results', anchor)
        bdr = float(bd_rate(anchor['bpp'], anchor['psnr'], results['bpp'],
                            results['psnr']))
    except (FileNotFoundError, KeyError):
        bdr = float(results['loss'][len(results['loss']) // 2])
    lambdas = results['lambda']
    to_log = {'bd-rate': bdr}
    for idx in [0, len(lambdas) // 2, -1]:
        lmb = round(lambdas[idx])
        to_log.update({
            f'lmb{lmb}/loss': results['loss'][idx],
            f'lmb{lmb}/bpp': results['bpp'][idx],
            f'lmb{lmb}/psnr': results['psnr'][idx],
        })
    results['loss'] = bdr
    results['bd-rate'] = bdr
    return to_log


class TrainWrapper(BaseTrainingWrapper):
    def set_dataset(self):
        cfg = self.cfg
        logging.info('==== Datasets and Dataloaders ====')
        trainset = get_image_dateset(cfg.trainset, transform_cfg=cfg.transform,
                                     decode_cache=cfg.data_cache)
        self.make_training_loader(trainset)
        logging.info(f'Training root: {trainset.root}; N = {len(trainset)}')

    def eval_model(self, model) -> dict:
        cfg = self.cfg
        val_img_dir = known_datasets.get(cfg.valset, cfg.valset)
        results = model.self_evaluate(val_img_dir, steps=cfg.val_steps,
                                      log_dir=self._log_dir)
        process_log_results(results, cfg.valset)
        return results


def main(argv=None, device=None):
    """Train on argv (sys.argv when None) -> the finished TrainWrapper.
    `device` overrides --device (tests pass 'cpu')."""
    cfg = build_config(argv)
    return TrainWrapper(cfg, device or cfg.device).main()


if __name__ == '__main__':
    main()
