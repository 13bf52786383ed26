"""Entry point: `python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout (see harness.py)."""

import time

T_PROCESS = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

if __name__ == "__main__":
    from benchmark.harness import main
    sys.exit(main(sys.argv[1:], t_process=T_PROCESS))
