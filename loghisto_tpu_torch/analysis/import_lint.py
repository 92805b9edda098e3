"""Import-graph linter: AST-level module graph over
``loghisto_tpu_torch/`` enforcing the port's layering (counterpart of
``loghisto_tpu/analysis/import_lint.py``).

Three rules:

  * **no JAX stack, anywhere** — any ``import`` or ``from ... import``
    whose first dotted component is ``jax``, ``jaxlib`` or
    ``loghisto_tpu`` is a finding, in a function body too: the port
    keeps its own copy of what it needs from the reference.  The first
    component is compared whole, so ``loghisto_tpu_torch`` passes.
  * **torch-free frontier** — the modules that run inside emitter /
    host-only processes (``federation.emitter``, ``labels.model``,
    ``obs.spans``, ``metrics``, ``submitter``) and this analyzer must
    not *transitively* reach torch or triton at import time.  The
    finding names the offending import chain.
  * **lazy surfaces resolve** — every package ``__init__`` that defines
    a PEP 562 ``__getattr__`` must resolve every name it advertises in
    ``__all__`` (a renamed symbol behind a lazy indirection otherwise
    fails only at first customer access).

For the frontier only module-level imports count: an import inside a
function body is a deliberate lazy import (the port's standard idiom
for keeping torch off the frontier), and ``if TYPE_CHECKING:`` blocks
never execute.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Iterable

from loghisto_tpu_torch.analysis import Finding, REPO_ROOT, relpath

PACKAGE = "loghisto_tpu_torch"
PACKAGE_ROOT = os.path.join(REPO_ROOT, PACKAGE)
LINT_PATH = "loghisto_tpu_torch/analysis/import_lint.py"

# First dotted components no module of the port may import, anywhere.
JAX_STACK = ("jax", "jaxlib", "loghisto_tpu")

# Modules that must stay importable in a process with no accelerator
# stack: the federation emitter tier, the label data model, the span
# ring, the host metrics registry, the submitter the emitter ships
# through, and the analyzer itself (it gates hosts without a card; the
# program auditor imports torch only inside the functions that run a
# step).
TORCH_FREE_FRONTIER = (
    "loghisto_tpu_torch.federation.emitter",
    "loghisto_tpu_torch.labels.model",
    "loghisto_tpu_torch.obs.spans",
    "loghisto_tpu_torch.metrics",
    "loghisto_tpu_torch.submitter",
    "loghisto_tpu_torch.analysis",
    "loghisto_tpu_torch.analysis.import_lint",
    "loghisto_tpu_torch.analysis.lock_lint",
    "loghisto_tpu_torch.analysis.program_audit",
)

# Top-level distributions the frontier must never reach at import time.
FORBIDDEN_ROOTS = ("torch", "triton")


def _is_type_checking_test(test: ast.expr) -> bool:
    return (isinstance(test, ast.Name) and test.id == "TYPE_CHECKING") or (
        isinstance(test, ast.Attribute) and test.attr == "TYPE_CHECKING"
    )


def _module_level_imports(tree: ast.Module) -> Iterable[ast.stmt]:
    """Import statements that execute at import time: module body plus
    any try/if/with nesting — but not function bodies (lazy imports)
    or TYPE_CHECKING blocks (never execute)."""
    stack: list[ast.stmt] = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        elif isinstance(node, ast.If):
            if not _is_type_checking_test(node.test):
                stack.extend(node.body)
            stack.extend(node.orelse)
        elif isinstance(node, ast.Try):
            stack.extend(node.body)
            for handler in node.handlers:
                stack.extend(handler.body)
            stack.extend(node.orelse)
            stack.extend(node.finalbody)
        elif isinstance(node, (ast.With, ast.ClassDef)):
            stack.extend(node.body)


def _module_name(path: str, root: str = REPO_ROOT,
                 package: str = PACKAGE) -> str | None:
    rel = os.path.relpath(path, root)
    if not rel.endswith(".py"):
        return None
    parts = rel[:-3].split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    if not parts or parts[0] != package:
        return None
    return ".".join(parts)


def _package_files(package_root: str, package: str,
                   repo_root: str) -> dict[str, str]:
    """module name -> file for every ``.py`` under the package."""
    files: dict[str, str] = {}
    for dirpath, _dirnames, filenames in os.walk(package_root):
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            mod = _module_name(path, repo_root, package)
            if mod is not None:
                files[mod] = path
    return files


def _parse(path: str) -> ast.Module:
    with open(path, "r", encoding="utf-8") as fh:
        return ast.parse(fh.read(), filename=path)


def build_import_graph(
    package_root: str = PACKAGE_ROOT, package: str = PACKAGE,
    repo_root: str = REPO_ROOT,
) -> dict[str, list[tuple[str, str, int]]]:
    """module -> [(imported module, file, line)] for every module-level
    import in the package tree.  ``from pkg import name`` records both
    ``pkg`` and ``pkg.name`` when the latter is itself a module."""
    files = _package_files(package_root, package, repo_root)
    modules = set(files)
    graph: dict[str, list[tuple[str, str, int]]] = {}
    for mod, path in files.items():
        edges: list[tuple[str, str, int]] = []
        is_pkg = os.path.basename(path) == "__init__.py"
        for node in _module_level_imports(_parse(path)):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    edges.append((alias.name, path, node.lineno))
            else:  # ImportFrom
                if node.level:
                    base_parts = mod.split(".")
                    # a package's own __init__ resolves level-1 against
                    # itself, a plain module against its parent package
                    up = node.level - (1 if is_pkg else 0)
                    if up:
                        base_parts = base_parts[:-up]
                    base = ".".join(base_parts)
                    target = f"{base}.{node.module}" if node.module else base
                else:
                    target = node.module or ""
                if target:
                    edges.append((target, path, node.lineno))
                for alias in node.names:
                    sub = f"{target}.{alias.name}" if target else alias.name
                    if sub in modules:
                        edges.append((sub, path, node.lineno))
        graph[mod] = edges
    return graph


def jax_stack_findings(
    package_root: str = PACKAGE_ROOT, package: str = PACKAGE,
    repo_root: str = REPO_ROOT,
) -> list[Finding]:
    """Rule 1: every absolute import anywhere in a module (function
    bodies and TYPE_CHECKING blocks included) whose first component is
    one of ``JAX_STACK``."""
    out: list[Finding] = []
    for mod, path in _package_files(package_root, package,
                                    repo_root).items():
        for node in ast.walk(_parse(path)):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in JAX_STACK:
                    out.append(Finding(
                        "imports", relpath(path), node.lineno, mod,
                        f"jax-stack-import:{name}",
                        f"{mod} imports {name}: the port imports nothing "
                        "of jax, jaxlib or loghisto_tpu, not even inside "
                        "a function",
                    ))
    return out


def _closure_chain(
    graph: dict, start: str, forbidden_roots: tuple,
) -> tuple[list[str], str, int] | None:
    """BFS the import-time closure of ``start``; on reaching a forbidden
    root, return (module chain, offending file, line)."""
    parent: dict[str, tuple[str, str, int] | None] = {start: None}
    # importing pkg.sub executes pkg's __init__ first
    parts = start.split(".")
    queue = [start]
    for depth in range(1, len(parts)):
        prefix = ".".join(parts[:depth])
        if prefix in graph and prefix not in parent:
            parent[prefix] = (start, "", 0)
            queue.append(prefix)
    while queue:
        mod = queue.pop(0)
        for target, path, line in graph.get(mod, ()):
            root = target.split(".")[0]
            if root in forbidden_roots:
                chain = [target]
                cursor: str | None = mod
                while cursor is not None:
                    chain.append(cursor)
                    entry = parent[cursor]
                    cursor = entry[0] if entry else None
                return list(reversed(chain)), path, line
            # importing pkg.sub executes pkg's __init__ too
            parts = target.split(".")
            for depth in range(1, len(parts) + 1):
                prefix = ".".join(parts[:depth])
                if prefix in graph and prefix not in parent:
                    parent[prefix] = (mod, path, line)
                    queue.append(prefix)
    return None


def frontier_findings(
    frontier: tuple = TORCH_FREE_FRONTIER,
    forbidden_roots: tuple = FORBIDDEN_ROOTS,
    graph: dict | None = None,
) -> list[Finding]:
    """Rule 2: the frontier's import-time closure reaches no forbidden
    root."""
    if graph is None:
        graph = build_import_graph()
    out: list[Finding] = []
    for mod in frontier:
        if mod not in graph:
            out.append(Finding(
                "imports", LINT_PATH, 1, mod, "frontier-missing",
                f"declared torch-free frontier module {mod} does not "
                "exist — update TORCH_FREE_FRONTIER",
            ))
            continue
        hit = _closure_chain(graph, mod, forbidden_roots)
        if hit is not None:
            chain, path, line = hit
            out.append(Finding(
                "imports", relpath(path), line, mod,
                f"torch-import:{chain[-1]}",
                f"torch-free frontier module {mod} transitively imports "
                f"{chain[-1]} at import time: {' -> '.join(chain)}",
            ))
    return out


def lazy_surfaces(
    package_root: str = PACKAGE_ROOT, package: str = PACKAGE,
    repo_root: str = REPO_ROOT,
) -> tuple[str, ...]:
    """Every package of the tree whose ``__init__`` defines a
    module-level ``__getattr__`` (PEP 562)."""
    out = []
    for mod, path in _package_files(package_root, package,
                                    repo_root).items():
        if os.path.basename(path) != "__init__.py":
            continue
        if any(isinstance(node, ast.FunctionDef)
               and node.name == "__getattr__"
               for node in _parse(path).body):
            out.append(mod)
    return tuple(sorted(out))


def lazy_surface_findings(
    surfaces: tuple | None = None, repo_root: str = REPO_ROOT,
) -> list[Finding]:
    """Rule 3: resolve every ``__all__`` name of the PEP 562 surfaces.
    This is a *dynamic* check by design: the lazy indirection's whole
    failure mode is a name that parses fine and only breaks on
    getattr."""
    import importlib

    if surfaces is None:
        surfaces = lazy_surfaces()
    if repo_root not in sys.path:
        sys.path.insert(0, repo_root)
    out: list[Finding] = []
    for modname in surfaces:
        try:
            mod = importlib.import_module(modname)
        except Exception as exc:
            out.append(Finding(
                "imports", modname, 1, modname, "lazy-surface-import",
                f"importing the lazy surface {modname} raises "
                f"{type(exc).__name__}: {exc}",
            ))
            continue
        path = relpath(getattr(mod, "__file__", None) or modname)
        for name in getattr(mod, "__all__", ()):
            try:
                getattr(mod, name)
            except Exception as exc:  # AttributeError or deeper ImportError
                out.append(Finding(
                    "imports", path, 1, modname, f"lazy-surface:{name}",
                    f"{modname}.__all__ advertises {name!r} but "
                    f"resolving it raises {type(exc).__name__}: {exc}",
                ))
    return out


def run(
    package_root: str = PACKAGE_ROOT, package: str = PACKAGE,
    repo_root: str = REPO_ROOT, frontier: tuple = TORCH_FREE_FRONTIER,
) -> list[Finding]:
    """The three rules over one package tree."""
    out = jax_stack_findings(package_root, package, repo_root)
    out.extend(frontier_findings(
        frontier=frontier,
        graph=build_import_graph(package_root, package, repo_root),
    ))
    out.extend(lazy_surface_findings(
        lazy_surfaces(package_root, package, repo_root), repo_root,
    ))
    return out
