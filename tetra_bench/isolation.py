"""What the benchmark's process may not hold, and what its reference may
not import.

Names are compared by their top-level part, whole: tetra_tpu_torch is
the program under test, tetra_tpu the JAX package it was ported from.
"""

from __future__ import annotations

import ast
import os
import sys

JAX_NAMES = ("jax", "jaxlib", "flax", "tetra_tpu")
PROGRAM = "tetra_tpu_torch"
BENCH = os.path.dirname(os.path.abspath(__file__))
# the reference that decides `correct`, and the air it judges against
REFERENCE_PACKAGES = ("reference", "air")


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in list(names)} & set(JAX_NAMES))


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                out.add("." * node.level + (node.module or ""))
            else:
                out.add(node.module)
    return out


def reference_imports() -> list:
    """Every module the reference's and the air's sources import (their
    relative imports within the benchmark followed), by top-level name,
    that is the program, the JAX package or JAX."""
    bad = set()
    for pkg in REFERENCE_PACKAGES:
        d = os.path.join(BENCH, pkg)
        for name in sorted(os.listdir(d)):
            if not name.endswith(".py"):
                continue
            for mod in _imports(os.path.join(d, name)):
                if mod.startswith("..") and mod.lstrip(".").split(".")[0] \
                        not in REFERENCE_PACKAGES + ("",):
                    bad.add("tetra_bench." + mod.lstrip("."))
                top = mod.lstrip(".").split(".")[0]
                if not mod.startswith(".") and top in JAX_NAMES + (PROGRAM,):
                    bad.add(mod)
    return sorted(bad)
