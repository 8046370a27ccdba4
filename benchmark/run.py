"""Run one cell of BENCHMARK.json once on the card:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result JSON; the numbers compared against their limits are the last lines
of standard error. Exits with 2 and prints no result without enough CUDA
cards."""
import os
import sys
import time

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# every build and kernel cache inside the checkout, at fixed paths (the
# port builds csrc/ into lvae_tpu_torch/_build/ itself)
for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('TRITON_CACHE_DIR', 'triton'),
                 ('CUDA_CACHE_PATH', 'nv_compute')):
    os.environ[var] = os.path.join(HERE, '.cache', sub)

sys.path[:0] = [HERE, ROOT]

from harness.main import main  # noqa: E402

if __name__ == '__main__':
    sys.exit(main(sys.argv[1:], T0))
