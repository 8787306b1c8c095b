"""The import guard: no run loads JAX or the JAX package, and the
reference imports nothing of the port.

Names are compared whole by their top-level part (before the first
dot): the port's name begins with the JAX package's, so a prefix test
would be wrong.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "unitysspathtracingurp_tpu")
PORT = "unitysspathtracingurp_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top(n) in FORBIDDEN)


def imports_of(path: Path) -> set:
    """Top-level names that one source file imports (absolute imports)."""
    tree = ast.parse(Path(path).read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(top(node.module))
    return out


def reference_violations(ref_dir: Path) -> list:
    """(file, name) of every import of the port, JAX or the JAX package
    in the reference's sources."""
    bad = set(FORBIDDEN) | {PORT}
    return sorted((str(p), n) for p in sorted(Path(ref_dir).rglob("*.py"))
                  for n in imports_of(p) if n in bad)
