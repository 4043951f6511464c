"""Run one cell of the benchmark of polyblur_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. Prints, on
standard output, a line with the routes the calls took and the card, then
the result as one JSON object on the last line; on standard error, last,
each number of the check beside its limit. Exits with another code than 0,
printing no result, where there is no card (or fewer than the cell asks
for), where the program is not in the checkout, or where JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench_cache"
# Python's bytecode is a build cache too: where the environment forbids
# writing it beside the sources, every process would compile all of
# torch's again (seconds of set-up); the first run in a checkout writes it
# at a fixed path there and later runs read it
sys.pycache_prefix = str(CACHE / "pycache")
sys.dont_write_bytecode = False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache a library could write lives at a fixed path in the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    _, entry, _, _ = harness.cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"run.py: {args.workload} needs {entry['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return report(args.workload, args.seed, args.seconds, bool(args.trace))


def report(workload: str, seed: int, seconds: float, trace: bool,
           **run_kw) -> int:
    """Run the cell once and print its result; 3, printing no result,
    where the harness cannot report. ``run_kw`` goes to
    ``harness.run_cell`` (the tests' device and sizes)."""
    from benchmark import harness

    try:
        result, info = harness.run_cell(workload, seed, seconds, trace,
                                        T_START, **run_kw)
    except harness.HarnessError as e:
        print(f"run.py: {e}", file=sys.stderr)
        return 3
    print(json.dumps(info))
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
