"""The RD model's theoretical evaluation CLI, counterpart of
``lvae_tpu/models/rd/evaluate.py``: RDModel.self_evaluate over each dataset
(a ``paths.known_datasets`` name or a directory of PNGs) at --steps
lambdas, written to runs/results/<dataset>-<model>.json under the working
directory as {name, dataset, results}. No entropy coding: bpp =
sum(KL) * log2(e) / (H * W). Runs on the card:

    python -m lvae_tpu_torch.models.rd.evaluate -m rd_model_base \
        -n images -s 8
"""
import argparse
import json
from collections import OrderedDict
from pathlib import Path

from lvae_tpu_torch.datasets import parse_transform_cfg
from lvae_tpu_torch.paths import known_datasets
from lvae_tpu_torch.registry import get_model


def evaluate_model(model, dataset_name, steps=8, lmb_range=None):
    root = known_datasets.get(dataset_name, Path(dataset_name))
    return model.self_evaluate(root, lmb_range=lmb_range, steps=steps)


def main(argv=None, device=None):
    """The CLI on argv (sys.argv when None). `device` is where the model
    runs: None, the card (there is no CPU fallback); tests pass 'cpu'.
    Returns {dataset: its file's dict}."""
    parser = argparse.ArgumentParser()
    parser.add_argument('-m', '--model', type=str, default='rd_model_base')
    parser.add_argument('-a', '--model_args', type=str, default='')
    parser.add_argument('-n', '--datasets', type=str, nargs='+',
                        default=['kodak'])
    parser.add_argument('-s', '--steps', type=int, default=8)
    args = parser.parse_args(argv)

    model = get_model(args.model, device=device,
                      **parse_transform_cfg(args.model_args))

    out = {}
    for name in args.datasets:
        results = evaluate_model(model, name, steps=args.steps)
        save_path = Path(f'runs/results/{name}-{args.model}.json')
        save_path.parent.mkdir(parents=True, exist_ok=True)
        data = OrderedDict(name=args.model, dataset=name, results=results)
        with open(save_path, 'w') as f:
            json.dump(data, f, indent=4)
        print(f'{name}: {results}')
        out[name] = data
    return out


if __name__ == '__main__':
    main()
