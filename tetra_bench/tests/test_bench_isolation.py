"""Nothing the benchmark runs loads JAX or the JAX package, and its
reference imports nothing of the program."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, REPO, clean_python

from tetra_bench.isolation import forbidden_modules, reference_imports


def test_names_are_compared_whole():
    assert forbidden_modules({"tetra_tpu_torch": 0, "tetra_tpu_torch.rx": 0,
                              "numpy": 0}) == []
    assert forbidden_modules({"tetra_tpu.rx.fleet": 0}) == ["tetra_tpu"]
    assert forbidden_modules({"jax._src": 0, "jaxlib": 0, "flax": 0}) == \
        ["flax", "jax", "jaxlib"]


def test_reference_sources_import_no_program():
    assert reference_imports() == []


def test_reference_import_graph_holds_no_program():
    code = """
import json, sys
import tetra_bench.reference.frontend, tetra_bench.reference.truth
import tetra_bench.air.synth, tetra_bench.control, tetra_bench.work
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""
    out = clean_python(code, REPO)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.splitlines()[-1]))
    assert not tops & {"tetra_tpu_torch", "tetra_tpu", "jax", "jaxlib"}


def test_a_run_loads_no_jax(bench_copy):
    code = f"""
import json, sys, time
sys.path[:0] = [{bench_copy!r}, {REPO!r}]
from tetra_bench.harness import run_cell
from tetra_bench.isolation import forbidden_modules
res, checks = run_cell({bench_copy!r}, "small.sparse", 2**31 + 5, 2.0, False,
                       time.perf_counter(), device="cpu")
print(json.dumps([forbidden_modules(),
                  "tetra_tpu_torch" in sys.modules]))
"""
    out = clean_python(code, bench_copy)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == [[], True]


# a cell module's checks decide `correct` too: it may import neither the
# program nor JAX, nor a benchmark module outside the reference, the air
# and cells/ (it reaches the program only through the receiver handed to
# it)
PLANTED = {
    "program": ("import numpy as np\nimport tetra_tpu_torch.voice\n",
                "tetra_tpu_torch.voice"),
    "program_in_a_function": (
        "def checks(data, air, seed, limits):\n"
        "    from tetra_tpu_torch.crypto import tea\n    return []\n",
        "tetra_tpu_torch.crypto"),
    "jax_package": ("from tetra_tpu.rx import fleet\n", "tetra_tpu.rx"),
    "harness": ("from tetra_bench.harness import run_cell\n",
                "tetra_bench.harness"),
    "harness_relative": ("from ..harness import run_cell\n",
                         "tetra_bench.harness"),
}


def _plant(root: str, source: str) -> str:
    cells = os.path.join(root, "tetra_bench", "cells")
    os.makedirs(cells, exist_ok=True)
    with open(os.path.join(cells, "planted.py"), "w") as f:
        f.write(source)
    return os.path.join(root, "tetra_bench")


def _run_py(root: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "tetra_bench/run.py", "--workload", "small.full",
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("case", sorted(PLANTED))
def test_a_cell_module_importing_the_program_is_found(bench_copy, case):
    source, name = PLANTED[case]
    assert reference_imports(_plant(bench_copy, source)) == [name]


def test_run_refuses_a_cell_module_importing_the_program(bench_copy):
    _plant(bench_copy, PLANTED["program"][0])
    out = _run_py(bench_copy)
    assert out.returncode == 3 and out.stdout == ""
    assert "the reference imports tetra_tpu_torch.voice" in out.stderr


def test_the_test_cell_module_passes_the_isolation_check(bench_copy):
    with open(os.path.join(BENCH, "tests", "voice_count_cell.py")) as f:
        bench = _plant(bench_copy, f.read())
    assert reference_imports(bench) == []
    if not torch.cuda.is_available():
        # no refusal: the run goes on to look for a CUDA device
        out = _run_py(bench_copy)
        assert out.returncode == 2 and out.stdout == ""
        assert "CUDA device" in out.stderr
