"""Variable-rate evaluation CLI, counterpart of ``eval-var-rate.py``: one
model, lambdas log-spaced over --lmb_range, the true file round trip of a
dataset at each (evaluation.imcoding_evaluate), and
runs/results/<dataset>-<model>.json under the working directory, with the
BD-rate against the dataset's VTM anchor when one is found. Runs on the
card:

    python -m lvae_tpu_torch.eval_var_rate -m qarv_base \
        -w checkpoints/qarv_base_mixed20k_ema_f16.msgpack -n images -s 6
"""
import argparse
import json
import math
import platform
import subprocess
from collections import OrderedDict, defaultdict
from pathlib import Path

import numpy as np

from lvae_tpu_torch.datasets import parse_transform_cfg
from lvae_tpu_torch.evaluation import imcoding_evaluate
from lvae_tpu_torch.registry import get_model
from lvae_tpu_torch.utils.coding import RDList


def device_name(device):
    """The card's name and power limit as nvidia-smi prints them (the
    result file's 'device'); the device's name for the CPU."""
    if device is not None and str(device) == 'cpu':
        return 'cpu'
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def print_lists(all_lmb_stats):
    for k, vlist in all_lmb_stats.items():
        print(f'{k:<6s} = [' + ', '.join(f'{v:.12f}'[:7] for v in vlist)
              + ']')


def save_results(model_name, dataset_key, test_set, lambdas, all_lmb_stats,
                 device, anchor=None):
    """Write runs/results/<dataset_key>-<model_name>.json under the working
    directory (both CLIs' result file): the model, the test set, the
    platform, the card, the lambdas and each stat's list over them, with
    the BD-rate against `anchor` (a results JSON's path) when one is given.
    Prints the lists and returns the file's dict."""
    json_data = OrderedDict()
    json_data['name'] = model_name
    json_data['test-set'] = test_set
    json_data['platform'] = platform.platform()
    json_data['device'] = device_name(device)
    json_data['lambdas'] = lambdas
    json_data['results'] = all_lmb_stats
    if anchor:
        rd = RDList()
        rd.add_json(anchor, label=Path(anchor).stem)
        rd.add_data(bpp=all_lmb_stats['bpp'], psnr=all_lmb_stats['psnr'],
                    label=model_name)
        rd.set_bdrate_anchor(Path(anchor).stem)
        json_data['bd-rate'] = rd.compute_bdrate()
    save_json_path = Path(f'runs/results/{dataset_key}-{model_name}.json')
    save_json_path.parent.mkdir(parents=True, exist_ok=True)
    with open(save_json_path, 'w') as f:
        json.dump(json_data, fp=f, indent=4)
    print(f'\nSaved results to {save_json_path}\n')
    print_lists(all_lmb_stats)
    return json_data


def main(argv=None, device=None):
    """The CLI on argv (sys.argv when None). `device` is where the model
    runs: None, the card (there is no CPU fallback); tests pass 'cpu'."""
    parser = argparse.ArgumentParser()
    parser.add_argument('-m', '--model',        type=str, default='qarv_base')
    parser.add_argument('-a', '--model_args',   type=str, default='')
    parser.add_argument('-w', '--weights',      type=str, default=None)
    parser.add_argument('-l', '--lmb_range',    type=float, default=[16, 2048],
                        nargs='+')
    parser.add_argument('-s', '--steps',        type=int, default=16)
    parser.add_argument('-n', '--dataset_name', type=str, default='kodak')
    # pad images to <= N shape buckets; default: each to the stride
    parser.add_argument('-b', '--shape_buckets', type=int, default=None)
    # BD-rate anchor curve; 'auto' takes results/<set>/<set>-vtm18.0.json
    # when it exists
    parser.add_argument('--bd_anchor', type=str, default='auto')
    args = parser.parse_args(argv)

    kwargs = parse_transform_cfg(args.model_args)
    if args.weights:
        kwargs['pretrained'] = args.weights
    model = get_model(args.model, device=device, **kwargs)
    model.compress_mode()

    start, end = args.lmb_range
    lambdas = np.exp(np.linspace(math.log(start), math.log(end),
                                 args.steps)).tolist()
    all_lmb_stats = defaultdict(list)
    for lmb in lambdas:
        model.default_lmb = lmb
        results = imcoding_evaluate(model, args.dataset_name,
                                    shape_buckets=args.shape_buckets)
        print(f'lmb={lmb:.2f}: {results}')
        for k, v in results.items():
            all_lmb_stats[k].append(v)

    # a dataset given as a path is keyed by its basename
    dataset_key = Path(args.dataset_name).name or args.dataset_name
    anchor = args.bd_anchor
    if anchor == 'auto':
        cand = Path(f'results/{dataset_key}/{dataset_key}-vtm18.0.json')
        anchor = str(cand) if cand.exists() else None
    return save_results(args.model, dataset_key, args.dataset_name, lambdas,
                        all_lmb_stats, model.device, anchor)


if __name__ == '__main__':
    main()
