"""One run of one benchmark cell of dynamorph_tpu_torch.

    python3 benchmarks/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. The last line of standard output is the result (see
``yardstick/harness.py``).
"""
import time

T0 = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from yardstick.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
