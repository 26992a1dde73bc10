"""What the benchmark may not load: the JAX package and JAX itself.

Module names are compared by their top-level part (before the first dot),
whole: ``hawq_tpu_torch`` is not ``hawq_tpu``.  :func:`source_imports`
reads the imports of the benchmark's own files (every run does so at its
start, and a test does); :func:`loaded` reads ``sys.modules`` (every run
does so once its window has closed, which catches what the program loads).
The reference may not import the program either.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Iterator, List, Tuple

FORBIDDEN = frozenset({'jax', 'jaxlib', 'flax', 'hawq_tpu'})
PROGRAM = 'hawq_tpu_torch'
HERE = os.path.dirname(os.path.abspath(__file__))


def top(name: str) -> str:
    return name.split('.', 1)[0]


def loaded() -> List[str]:
    """The forbidden top-level modules in this process."""
    return sorted({top(m) for m in sys.modules} & FORBIDDEN)


def _imports(path: str) -> Iterator[str]:
    with open(path, encoding='utf-8') as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def source_imports(root: str = HERE) -> List[Tuple[str, str]]:
    """(file, module) of every forbidden import in the benchmark's files:
    JAX or the JAX package anywhere, the program in the reference."""
    bad = []
    for d, _, files in os.walk(root):
        for name in sorted(files):
            if not name.endswith('.py'):
                continue
            path = os.path.join(d, name)
            in_ref = os.path.relpath(path, root).startswith('reference')
            for mod in _imports(path):
                if top(mod) in FORBIDDEN or (in_ref and top(mod) == PROGRAM):
                    bad.append((os.path.relpath(path, root), mod))
    return bad
