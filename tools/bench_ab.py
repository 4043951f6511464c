#!/usr/bin/env python3
"""Benchmark cells of several trees in turn on one NVIDIA GPU, for an A/B
of two commits on the same card.

    python3 tools/bench_ab.py <out> <tree>:<cell>:<seed>:<trace> ...

Each ``<tree>`` is a checkout's directory relative to this repository's
root (``.`` for this one, e.g. ``build/parent`` for a parent unpacked with
``git archive <commit> | tar -x -C build/parent``). Builds every tree's
kernels first, all at once, so that no run's ``setup_s`` holds a build;
then runs ``benchmark/run.py --workload <cell> --seed <seed> --seconds
<the tree's run_seconds> --trace <trace>`` in each tree in the order given
(parent, change, change, parent, ...), keeps each run's output under
``<out>/`` (relative to the repository's root) and prints one line a run:
its exit code, wall time, metrics, ``correct``,
failed calls, peak memory and, traced, busy and window seconds."""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    out = os.path.join(ROOT, sys.argv[1])
    os.makedirs(out, exist_ok=True)
    runs = [a.split(":") for a in sys.argv[2:]]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    trees = sorted({r[0] for r in runs})
    t0 = time.time()
    build = "from polyblur_torch.ops.cuda import build; build()"
    procs = [subprocess.Popen([sys.executable, "-c", build],
                              cwd=os.path.join(ROOT, t),
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.STDOUT) for t in trees]
    print("build rcs", [p.wait() for p in procs],
          f"{time.time() - t0:.1f} s", flush=True)
    for i, (tree, cell, seed, trace) in enumerate(runs):
        tag = f"{i:02d}_{tree.replace('/', '_')}_{cell}_{seed}_{trace}"
        with open(os.path.join(ROOT, tree, "BENCHMARK.json")) as f:
            seconds = str(json.load(f)["run_seconds"])
        t = time.time()
        p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                            cell, "--seed", seed, "--seconds", seconds,
                            "--trace", trace], cwd=os.path.join(ROOT, tree),
                           capture_output=True, text=True)
        with open(os.path.join(out, tag + ".log"), "w") as f:
            f.write(p.stdout + "\n--- stderr ---\n" + p.stderr)
        try:
            r = json.loads(p.stdout.strip().splitlines()[-1])
            line = {k: round(v["value"], 5) for k, v in r["metrics"].items()}
            line["correct"] = r["correct"]
            line["failed"] = r["failed"]
            dv = r["device"]
            line["mem_GB"] = round(dv["memory_peak_bytes"] / 1e9, 3)
            if "busy_s" in dv:
                line["busy/window"] = (round(dv["busy_s"], 4),
                                       round(dv["window_s"], 4))
        except (ValueError, KeyError, IndexError) as e:  # no result line
            line = {"error": repr(e), "stderr": p.stderr[-600:]}
        print(tag, "rc", p.returncode, f"{time.time() - t:.1f} s",
              json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
