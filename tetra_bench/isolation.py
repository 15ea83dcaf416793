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
# the reference that decides `correct`, the air it judges against, and
# the cell modules whose checks add to it (they reach the program only
# through the receiver the harness hands them)
REFERENCE_PACKAGES = ("reference", "air", "cells")


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


def reference_imports(bench: str = BENCH) -> list:
    """Every module that the sources of the reference, the air and the
    cell modules (cells/, where there is one) import, anywhere in a file,
    that is the program, the JAX package or JAX, or a module of the
    benchmark (`tetra_bench` here) outside those three packages."""
    own = os.path.basename(bench)
    bad = set()
    for pkg in REFERENCE_PACKAGES:
        d = os.path.join(bench, pkg)
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if not name.endswith(".py"):
                continue
            for mod in _imports(os.path.join(d, name)):
                parts = mod.lstrip(".").split(".")
                if mod.startswith(".."):
                    sub = parts[0]
                elif not mod.startswith(".") and parts[0] == own:
                    sub = parts[1] if len(parts) > 1 else ""
                else:
                    sub = None
                if sub is not None and sub not in REFERENCE_PACKAGES:
                    bad.add(own + "." + sub if sub else own)
                if not mod.startswith(".") and parts[0] in JAX_NAMES + (
                        PROGRAM,):
                    bad.add(mod)
    return sorted(bad)
