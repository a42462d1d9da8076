"""Run one cell of the benchmark of ``bevy_gpu_fluid_tpu_torch`` once, on
one CUDA card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cells, configurations, traffic and
metrics are files under ``benchmark/`` found by the names in
``BENCHMARK.json``; the last line of standard output is the run's result
(JSON), and the numbers compared for ``correct`` close standard error.
Without a card, or with fewer than the cell asks for, it prints no result
and exits 3.  Build and kernel caches stay inside the checkout, at fixed
paths.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)


def main() -> int:
    cache = os.path.join(CHECKOUT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [HERE, CHECKOUT]
    from benchlib import harness
    return harness.main(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
