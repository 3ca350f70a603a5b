"""What a run may not load, and what a reference may not import.

Module names are compared by their top-level name (the part before the
first dot), whole: ``myzkp_tpu_torch`` is the program under test and is
allowed, ``myzkp_tpu`` (the JAX package it was ported from) is not.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

# never loaded in a run: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "myzkp_tpu"})
# never imported by a reference: the above and the program under test
PROGRAM = "myzkp_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list:
    """Names in ``modules`` (default ``sys.modules``) whose top-level name
    is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in FORBIDDEN)


def _imported(tree: ast.AST) -> list:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
    return out


def reference_violations(ref_dir: Path) -> list:
    """(file, module) for each import in the reference's sources whose
    top-level name is forbidden or the program's."""
    bad = FORBIDDEN | {PROGRAM}
    return [(path.name, name) for path in sorted(Path(ref_dir).glob("*.py"))
            for name in _imported(ast.parse(path.read_text(), str(path)))
            if top_level(name) in bad]
