"""Nothing the benchmark runs loads JAX or the JAX package, and its
reference imports nothing of the program."""

from __future__ import annotations

import json

from conftest import REPO, clean_python

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
