"""Fixed-rate evaluation CLI, counterpart of ``eval-fix-rate.py``: one
model per lambda of --lmbs (weights from a pattern with a {lmb}
placeholder), the true file round trip of a dataset with each
(evaluation.imcoding_evaluate), and runs/results/<dataset>-<model>.json
under the working directory (with the platform and the card, which the
JAX package's file lacks). Runs on the card:

    python -m lvae_tpu_torch.eval_fix_rate -m qres34m \
        -w 'weights/qres34m-lmb{lmb}.msgpack' -n kodak
"""
import argparse
from collections import defaultdict

from lvae_tpu_torch.datasets import parse_transform_cfg
from lvae_tpu_torch.eval_var_rate import save_results
from lvae_tpu_torch.evaluation import imcoding_evaluate
from lvae_tpu_torch.registry import get_model


def main(argv=None, device=None):
    """The CLI on argv (sys.argv when None). `device` is where the models
    run: None, the card (there is no CPU fallback); tests pass 'cpu'."""
    parser = argparse.ArgumentParser()
    parser.add_argument('-m', '--model',        type=str, default='qres34m')
    parser.add_argument('-a', '--model_args',   type=str, default='')
    parser.add_argument('-l', '--lmbs',         type=int, nargs='+',
                        default=[16, 32, 64, 128, 256, 512, 1024, 2048])
    parser.add_argument('-w', '--weights',      type=str, default=None,
                        help='weight file pattern with {lmb} placeholder')
    parser.add_argument('-n', '--dataset_name', type=str, default='kodak')
    # pad images to <= N shape buckets; default: each to the stride
    parser.add_argument('-b', '--shape_buckets', type=int, default=None)
    args = parser.parse_args(argv)

    all_lmb_stats = defaultdict(list)
    for lmb in args.lmbs:
        kwargs = parse_transform_cfg(args.model_args)
        kwargs['lmb'] = lmb
        if args.weights:
            kwargs['pretrained'] = args.weights.format(lmb=lmb)
        model = get_model(args.model, device=device, **kwargs)
        model.compress_mode()
        results = imcoding_evaluate(model, args.dataset_name,
                                    shape_buckets=args.shape_buckets)
        print(f'lmb={lmb}: {results}')
        for k, v in results.items():
            all_lmb_stats[k].append(v)

    return save_results(args.model, args.dataset_name, args.dataset_name,
                        args.lmbs, all_lmb_stats, model.device)


if __name__ == '__main__':
    main()
