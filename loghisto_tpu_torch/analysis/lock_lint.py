"""Concurrency-discipline lint: AST pass over ``loghisto_tpu_torch/``
(counterpart of ``loghisto_tpu/analysis/lock_lint.py``).

Two rules:

  * **no blocking call under a lock** — a device sync or device-to-host
    readback (``synchronize``, ``item``, ``cpu``, ``tolist``, a ``.to``
    whose target is a literal CPU device), a ``torch.distributed``
    collective or one of the port's helpers that makes one, and
    blocking socket ops must not execute inside a ``with <lock>:``
    block: every contender on that lock then stalls behind the device,
    the peers or the socket.  The reviewed cases are pinned in
    ``analysis/baseline.py`` with reasons.
  * **locked worker writes** — a function handed to a thread as an
    entry point (``threading.Thread(target=...)``, ``ThreadSupervisor
    .spawn(...)``) shares ``self`` with the spawning thread; plain
    ``self.attr = ...`` writes from the worker body outside any ``with
    <lock>:`` scope are unsynchronized publication.

Heuristics are name-based by design (a lock is anything whose terminal
name contains ``lock``, ``cond`` or ends in ``_cv``); the point is a
cheap tripwire with a reviewed baseline, not an alias-analysis prover.
A condition variable's ``wait`` releases its lock and is not blocking.
"""

from __future__ import annotations

import ast
import os

from loghisto_tpu_torch.analysis import Finding, REPO_ROOT, relpath

PACKAGE_ROOT = os.path.join(REPO_ROOT, "loghisto_tpu_torch")

# The reference's list: the JAX device syncs and the socket calls.
REFERENCE_BLOCKING_CALLS = {
    "block_until_ready": "device sync",
    "device_get": "blocking D2H readback",
    "recv": "blocking socket read",
    "recv_into": "blocking socket read",
    "recvfrom": "blocking socket read",
    "sendall": "blocking socket write",
    "accept": "blocking socket accept",
    "connect": "blocking socket connect",
    "create_connection": "blocking socket connect",
}

# ``torch.distributed`` collectives: every rank of the group waits for
# the slowest peer (through the host under gloo).
DIST_COLLECTIVES = (
    "all_reduce", "all_gather", "all_gather_object",
    "all_gather_into_tensor", "gather", "gather_object", "broadcast",
    "broadcast_object_list", "all_to_all", "all_to_all_single",
    "reduce_scatter", "barrier",
)

# Collectives whose terminal name is too common to match bare
# (``functools.reduce``): blocking only as ``dist.reduce(...)``.
QUALIFIED_COLLECTIVES = ("reduce",)

# The port's helpers that make a collective, by the names the port
# calls them by: every such function of ``parallel/mesh.py`` and the
# paged store's and aggregator's wrappers around them.
COLLECTIVE_HELPERS = (
    # parallel/mesh.py
    "mesh_reduce", "gather_parts", "reduce_parts", "host_gather",
    "agreed", "gather_objects", "gather_rows", "all_gather_objects",
    "gather_triples", "ragged_gather_triples", "_all_to_all_rows",
    "fold_rows",
    # paging.py PagedStore
    "_gather_cells", "decode_cells", "decode_dense", "fold_rows_into",
    "_extract_rows",
    # parallel/aggregator.py TorchAggregator
    "land_staged", "_gather_batches", "_mesh_regrow", "_mesh_state_dict",
    "_paged_mesh_state_dict",
)

# call-terminal-name -> what blocks
BLOCKING_CALLS = {
    **REFERENCE_BLOCKING_CALLS,
    "synchronize": "device sync",
    "item": "blocking D2H readback",
    "cpu": "blocking D2H readback",
    "tolist": "blocking D2H readback",
    **{name: "collective" for name in DIST_COLLECTIVES},
    **{name: "collective helper" for name in COLLECTIVE_HELPERS},
}


def _terminal_name(node: ast.expr) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Call):
        return _terminal_name(node.func)
    return None


def _is_cpu_device(node: ast.expr) -> bool:
    """The literal ``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (
        isinstance(node, ast.Call)
        and _terminal_name(node.func) == "device"
        and len(node.args) == 1
        and isinstance(node.args[0], ast.Constant)
        and node.args[0].value == "cpu"
    )


def blocking_reason(node: ast.Call,
                    table: dict | None = None) -> tuple[str, str] | None:
    """(name, what blocks) when the call blocks, else None.  ``table``
    replaces the name table (the reference's list in the parity test);
    the ``.to(cpu)`` and ``dist.reduce`` forms count only with the
    port's own."""
    name = _terminal_name(node.func)
    if table is not None:
        return (name, table[name]) if name in table else None
    if name in BLOCKING_CALLS:
        return name, BLOCKING_CALLS[name]
    if name == "to" and isinstance(node.func, ast.Attribute):
        target = node.args[0] if node.args else next(
            (kw.value for kw in node.keywords if kw.arg == "device"), None)
        if target is not None and _is_cpu_device(target):
            return "to_cpu", "blocking D2H readback"
    if (name in QUALIFIED_COLLECTIVES
            and isinstance(node.func, ast.Attribute)
            and _terminal_name(node.func.value) in ("dist", "distributed")):
        return name, "collective"
    return None


def _lock_name(node: ast.expr) -> str | None:
    """The lock a ``with`` item acquires, if its terminal name smells
    like one (``self._lock``, ``shard.lock``, ``self._dev_lock``);
    condition variables (``self._xfer_cv``) wrap a lock and count as
    lock scope for both rules."""
    name = _terminal_name(node)
    if name is None:
        return None
    low = name.lower()
    if "lock" in low or "cond" in low or low.endswith("_cv") or low == "cv":
        return name
    return None


class _FunctionScanner(ast.NodeVisitor):
    """Scan one function body tracking the with-lock nesting depth."""

    def __init__(self, path: str, qualname: str, findings: list,
                 table: dict | None):
        self.path = path
        self.qualname = qualname
        self.findings = findings
        self.table = table
        self.lock_stack: list[str] = []

    # nested defs get their own scan via _iter_functions; don't descend
    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_With(self, node: ast.With):
        locks = [
            _lock_name(item.context_expr) for item in node.items
        ]
        locks = [name for name in locks if name]
        self.lock_stack.extend(locks)
        for stmt in node.body:
            self.visit(stmt)
        for _ in locks:
            self.lock_stack.pop()

    visit_AsyncWith = visit_With

    def visit_Call(self, node: ast.Call):
        hit = blocking_reason(node, self.table) if self.lock_stack else None
        if hit is not None:
            name, what = hit
            self.findings.append(Finding(
                "locks", relpath(self.path), node.lineno,
                self.qualname, f"blocking-under-lock:{name}",
                f"{what} `{name}` while holding "
                f"`{self.lock_stack[-1]}` — every contender on the lock "
                "stalls behind it",
            ))
        self.generic_visit(node)


class _EntryScanner(ast.NodeVisitor):
    """Find names handed to threads as entry points in one file."""

    def __init__(self):
        self.entry_names: set[str] = set()

    def visit_Call(self, node: ast.Call):
        callee = _terminal_name(node.func)
        candidates: list[ast.expr] = []
        if callee == "Thread":
            candidates += [kw.value for kw in node.keywords
                           if kw.arg == "target"]
        elif callee == "spawn":
            if node.args:
                candidates.append(node.args[0])
            candidates += [kw.value for kw in node.keywords
                           if kw.arg in ("target", "fn")]
        for cand in candidates:
            if isinstance(cand, ast.Call):   # functools.partial(self.f,...)
                cand = cand.args[0] if cand.args else cand.func
            name = _terminal_name(cand)
            if name:
                self.entry_names.add(name)
        self.generic_visit(node)


def _iter_functions(tree: ast.Module):
    """(qualname, node) for every def, including methods and nested."""
    stack = [("", node) for node in tree.body]
    while stack:
        prefix, node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qual = f"{prefix}{node.name}"
            yield qual, node
            stack.extend((f"{qual}.", child) for child in node.body
                         if isinstance(child, (ast.FunctionDef,
                                               ast.AsyncFunctionDef,
                                               ast.ClassDef)))
        elif isinstance(node, ast.ClassDef):
            stack.extend((f"{node.name}.", child) for child in node.body)


class _EntryBodyScanner(ast.NodeVisitor):
    """Track with-lock scope inside a thread entry point and record
    ``self.attr`` writes that happen outside every lock."""

    def __init__(self):
        self.lock_depth = 0
        self.writes: dict[str, int] = {}

    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_With(self, node: ast.With):
        locked = any(_lock_name(i.context_expr) for i in node.items)
        self.lock_depth += bool(locked)
        for stmt in node.body:
            self.visit(stmt)
        self.lock_depth -= bool(locked)

    visit_AsyncWith = visit_With

    def _record(self, target: ast.expr, lineno: int):
        if (
            self.lock_depth == 0
            and isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
        ):
            self.writes.setdefault(target.attr, lineno)

    def visit_Assign(self, node: ast.Assign):
        for target in node.targets:
            self._record(target, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._record(node.target, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        self._record(node.target, node.lineno)
        self.generic_visit(node)


def lint_file(path: str, table: dict | None = None) -> list[Finding]:
    """Both rules over one file.  ``table`` replaces the blocking-call
    table (the parity test passes the reference's)."""
    with open(path, "r", encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)

    findings: list[Finding] = []
    functions = list(_iter_functions(tree))

    # rule 1: blocking calls under a lock, everywhere
    for qualname, node in functions:
        scanner = _FunctionScanner(path, qualname, findings, table)
        for stmt in node.body:
            scanner.visit(stmt)

    # rule 2: unlocked self-writes in thread entry points
    entries = _EntryScanner()
    entries.visit(tree)
    if entries.entry_names:
        for qualname, node in functions:
            if node.name not in entries.entry_names:
                continue
            body = _EntryBodyScanner()
            for stmt in node.body:
                body.visit(stmt)
            for attr, lineno in sorted(
                body.writes.items(), key=lambda kv: kv[1]
            ):
                findings.append(Finding(
                    "locks", relpath(path), lineno, qualname,
                    f"unlocked-worker-write:{attr}",
                    f"thread entry point `{qualname}` writes shared "
                    f"`self.{attr}` outside any lock scope",
                ))
    return findings


def run(package_root: str = PACKAGE_ROOT) -> list[Finding]:
    out: list[Finding] = []
    for dirpath, _dirnames, filenames in os.walk(package_root):
        for fname in sorted(filenames):
            if fname.endswith(".py"):
                out.extend(lint_file(os.path.join(dirpath, fname)))
    return sorted(out, key=lambda f: (f.path, f.line))
