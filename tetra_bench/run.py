"""The benchmark of tetra_tpu_torch's fleet receiver: one run of one cell.

    python3 tetra_bench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result as one JSON object; the numbers that decided `correct` are the
last lines of standard error and the last key of the result.  The run
fails, and prints no result, without a CUDA device, without the program
(tetra_tpu_torch) beside it, or if the JAX package or JAX itself was
loaded into the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel and build caches at fixed paths inside the checkout, so only a
# checkout's first run builds (the program's own build directory,
# tetra_tpu_torch/build, is inside it already)
CACHE = os.path.join(ROOT, ".bench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(CACHE, _sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    from tetra_bench.isolation import forbidden_modules, reference_imports
    bad = reference_imports()
    if bad:
        print(f"the reference imports {', '.join(bad)}", file=sys.stderr)
        return 3
    from tetra_bench.harness import cell_spec
    manifest, cell, _, _ = cell_spec(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from tetra_bench.harness import run_cell
    result, checks = run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the benchmark's process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r} "
              f"{'ok' if v is not None and v <= lim else 'FAIL'}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
