"""The readings the limits of ``correct`` are set from.

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--fault-seeds 7 8 9] [--seconds 2]

For each seed, one short run of the cell as the benchmark makes it (the
same pool, load and sample), printing the numbers its check compares: the
program's runs give the lower readings. With ``--control-seeds``, the same
for the control: the reference in the program's place, storing in the
precision below the configuration's (``control_dtype``), whose smallest
reading is the upper one. With ``--fault-seeds``, the same for each
fault the tests plant under the timed call (``faults_of`` the cell's
traffic in ``benchmark/tests/test_bench_control.py``: a training cell's
faults are planted in its step). One JSON line a run; the benchmark's own
runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness
    from benchmark.tests.test_bench_control import faults_of

    if not torch.cuda.is_available():
        print("readings.py: no CUDA device", file=sys.stderr)
        return 2
    runs = [(None, args.seeds), ("control", args.control_seeds)]
    _, _, _, traffic = harness.cell(ROOT, args.workload)
    runs += [(fault, args.fault_seeds) for fault in faults_of(traffic)]
    for sut, seeds in runs:
        for seed in seeds:
            result, _ = harness.run_cell(args.workload, seed, args.seconds,
                                         False, time.perf_counter(), sut=sut)
            print(json.dumps({
                "workload": args.workload, "seed": seed,
                "sut": getattr(sut, "__name__", sut or "program"),
                "calls": result["attempted"],
                **{k: c["value"] for k, c in result["checks"].items()}}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
