"""The harness is driven by the files: what a later change adds is found
by name. Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""

import ast
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

from benchmark import harness
from benchmark.tests.conftest import ROOT, small

BENCH = ROOT / "benchmark"


def _copy(tmp_path: Path) -> None:
    """``BENCHMARK.json`` and the benchmark's folder, copied."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))


def test_new_configuration_mix_and_metric_found_by_name(tmp_path):
    """A configuration, a traffic mix and a per-layer metric dropped into a
    copy of the benchmark, with their entries, run with no edit of a file
    that was there."""
    _copy(tmp_path)
    config = json.loads((BENCH / "configs" / "photo12mp_bf16.json").read_text())
    config["name"] = "photo_new"
    config["call"]["n_iter"] = 1
    (tmp_path / "benchmark" / "configs" / "photo_new.json").write_text(
        json.dumps(config))
    traffic = json.loads((BENCH / "traffic" / "single.json").read_text())
    traffic.update(name="pair", batch=2)
    (tmp_path / "benchmark" / "traffic" / "pair.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark" / "metrics" / "tiles_per_call.py").write_text(
        "def read(rec):\n    return rec.shapes.n\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "photo_new", "source": "x",
                             "file": "benchmark/configs/photo_new.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "photo_new.pair", "config": "photo_new",
                               "traffic": "pair", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "tiles_per_call", "unit": "tiles",
                               "better": "lower", "source": "program_counter",
                               "layer": "patches", "moves": "mp_per_s",
                               "workloads": ["photo_new.pair"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = harness.run_cell("photo_new.pair", 5, 0.2, True,
                                 time.perf_counter(), root=tmp_path,
                                 device="cpu", shrink=small)
    assert result["metrics"]["tiles_per_call"] == {"value": 12.0,
                                                   "unit": "tiles"}
    assert result["correct"] is True


def _imports(path: Path) -> set:
    """Top-level names of the modules a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in list((BENCH / "reference").rglob("*.py")) + [BENCH / "grid.py"]:
        assert "polyblur_torch" not in _imports(path), path
    code = ("import sys, torch; sys.path.insert(0, sys.argv[1]);"
            "from benchmark.reference import polyblur_ref as r;"
            "from benchmark import harness;"
            "_, _, c, _ = harness.cell(harness.ROOT, 'photo2mp_flags_bf16.single');"
            "x = torch.rand(1, 3, 460, 470);"
            "r.restore(x, c);"
            "r.restore(x, harness.load_json("
            " harness.ROOT / 'benchmark/configs/demo700k.json'));"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=600,
                         check=True).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert "polyblur_torch" not in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_a_run_loads_no_jax():
    """The modules loaded once a run's window has closed, in the process
    that reports, compared by whole top-level names (``polyblur_torch``
    begins with ``polyblur_t`` as the JAX package does)."""
    code = ("import sys, time; sys.path.insert(0, sys.argv[1]);"
            "from benchmark import harness;"
            "from benchmark.tests.conftest import small;"
            "harness.run_cell('photo12mp_bf16.single', 1, 0.1, False,"
            " time.perf_counter(), device='cpu', shrink=small);"
            "print(harness.forbidden_modules(), 'polyblur_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=600,
                         check=True).stdout
    assert out.strip().splitlines()[-1] == "[] True"


def test_a_reader_that_loads_jax_prints_no_result(tmp_path):
    """A metric's reader that imports a module named ``jax`` loads after
    the window and the check: the run still prints no result."""
    _copy(tmp_path)
    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    (tmp_path / "benchmark" / "metrics" / "jax_probe.py").write_text(
        "import jax\n\n\ndef read(rec):\n    return 1.0\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "jax_probe", "unit": "1",
                               "better": "lower", "source": "program_counter",
                               "layer": "patches", "moves": "mp_per_s",
                               "workloads": ["photo12mp_bf16.single"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, importlib.util; from pathlib import Path;"
            "sys.path[:0] = [sys.argv[1], sys.argv[2]];"
            "from benchmark.tests.conftest import small;"
            "spec = importlib.util.spec_from_file_location("
            " 'bench_run', Path(sys.argv[1]) / 'benchmark' / 'run.py');"
            "run = importlib.util.module_from_spec(spec);"
            "spec.loader.exec_module(run);"
            "rc = run.report('photo12mp_bf16.single', 3, 0.1, True,"
            " root=Path(sys.argv[3]), device='cpu', shrink=small);"
            "print('rc', rc, file=sys.stderr)")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT),
                          str(tmp_path / "stub"), str(tmp_path)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout == ""
    assert "forbidden modules loaded: ['jax']" in out.stderr
    assert out.stderr.strip().splitlines()[-1] == "rc 3"


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("polyblur_tpux_probe", type(sys)("probe"))
    try:
        assert harness.forbidden_modules() == []
    finally:
        del sys.modules["polyblur_tpux_probe"]
