"""The port's static analyzer (``loghisto_tpu_torch.analysis``): both
passes clean on the tree after the reviewed baseline, the CLI's exit
codes on the tree and on fixture trees that trip each rule (written into
``tmp_path`` from the strings below), fixtures that must stay clean,
the baseline's own hygiene, the collective helpers of
``parallel/mesh.py`` all named as blocking, and parity with the JAX
package's analyzer on the rules both share."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from loghisto_tpu_torch.analysis import Finding, apply_baseline
from loghisto_tpu_torch.analysis import baseline as baseline_mod
from loghisto_tpu_torch.analysis import import_lint, lock_lint

pytestmark = pytest.mark.static

REPO = Path(__file__).resolve().parent.parent
MESH = REPO / "loghisto_tpu_torch" / "parallel" / "mesh.py"


def _cli(*args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "loghisto_tpu_torch.analysis", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
    )


def _write_tree(root: Path, files: dict) -> None:
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))


# -- the tree --------------------------------------------------------------

def test_both_passes_clean_on_the_tree_after_the_baseline():
    findings = import_lint.run() + lock_lint.run()
    survivors = apply_baseline(findings, passes=("imports", "locks"))
    assert survivors == [], "\n".join(f.render() for f in survivors)
    # every pin still matches a finding (no stale entry survived above)
    assert len(findings) >= sum(1 for e in baseline_mod.BASELINE
                                if e[0] in ("imports", "locks"))


def test_cli_exits_zero_on_the_tree():
    proc = _cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout == ""
    assert "0 finding(s)" in proc.stderr


def test_the_lazy_surfaces_and_the_frontier_are_the_declared_ones():
    assert import_lint.lazy_surfaces() == (
        "loghisto_tpu_torch", "loghisto_tpu_torch.federation",
        "loghisto_tpu_torch.models", "loghisto_tpu_torch.ops",
        "loghisto_tpu_torch.parallel")
    assert set(import_lint.TORCH_FREE_FRONTIER) >= {
        "loghisto_tpu_torch.analysis",
        "loghisto_tpu_torch.analysis.import_lint",
        "loghisto_tpu_torch.analysis.lock_lint"}
    assert import_lint.frontier_findings(
        frontier=("loghisto_tpu_torch.no_such_module",))[0].detail == \
        "frontier-missing"


# -- fixture trees that trip each rule --------------------------------------

BAD_TREES = {
    "jax_in_a_function": (
        ("--pass", "imports", "--package", "lhfx"),
        {"lhfx/__init__.py": "",
         "lhfx/mod.py": """\
             def late():
                 import jax.numpy as jnp
                 return jnp
             """},
        "lhfx.mod imports jax.numpy",
    ),
    "frontier_reaches_torch_through_a_chain": (
        ("--pass", "imports", "--package", "lhfx",
         "--frontier", "lhfx.emitter"),
        {"lhfx/__init__.py": "",
         "lhfx/emitter.py": "from lhfx import helper\n",
         "lhfx/helper.py": "from lhfx.deep import thing\n",
         "lhfx/deep.py": "import torch\nthing = torch\n"},
        "lhfx.emitter -> lhfx.helper -> lhfx.deep -> torch",
    ),
    "frontier_parent_package_reaches_torch": (
        ("--pass", "imports", "--package", "lhfx",
         "--frontier", "lhfx.sub.emitter"),
        {"lhfx/__init__.py": "",
         "lhfx/sub/__init__.py": "import torch\n",
         "lhfx/sub/emitter.py": "VALUE = 1\n"},
        "lhfx.sub.emitter -> lhfx.sub -> torch",
    ),
    "lazy_name_does_not_resolve": (
        ("--pass", "imports", "--package", "lhfx_lazy"),
        {"lhfx_lazy/__init__.py": """\
             __all__ = ["present", "renamed_away"]


             def __getattr__(name):
                 if name == "present":
                     return 1
                 raise AttributeError(name)
             """},
        "advertises 'renamed_away'",
    ),
    "cpu_under_a_lock": (
        ("--pass", "locks"),
        {"w.py": """\
             import threading


             class W:
                 def __init__(self, t):
                     self._lock = threading.Lock()
                     self._t = t

                 def read(self):
                     with self._lock:
                         return self._t.cpu()
             """},
        "`cpu` while holding `_lock`",
    ),
    "to_cpu_under_a_lock": (
        ("--pass", "locks"),
        {"w.py": """\
             def read(state, lock):
                 with lock:
                     return state.acc.to("cpu", copy=True)
             """},
        "`to_cpu` while holding `lock`",
    ),
    "to_cpu_device_under_a_lock": (
        ("--pass", "locks"),
        {"w.py": """\
             import torch


             def read(state):
                 with state.dev_lock:
                     return state.acc.to(device=torch.device("cpu"))
             """},
        "`to_cpu` while holding `dev_lock`",
    ),
    "mesh_reduce_under_a_lock": (
        ("--pass", "locks"),
        {"w.py": """\
             from loghisto_tpu_torch.parallel.mesh import mesh_reduce


             class W:
                 def agree(self, mesh, op):
                     with self._dev_lock:
                         return mesh_reduce(mesh, [1], op)
             """},
        "collective helper `mesh_reduce` while holding `_dev_lock`",
    ),
    "dist_reduce_under_a_lock": (
        ("--pass", "locks"),
        {"w.py": """\
             import torch.distributed as dist


             def total(t, lock):
                 with lock:
                     dist.reduce(t, dst=0)
             """},
        "collective `reduce` while holding `lock`",
    ),
    "unlocked_write_in_a_thread_body": (
        ("--pass", "locks"),
        {"w.py": """\
             import threading


             class W:
                 def start(self):
                     threading.Thread(target=self._w, daemon=True).start()

                 def _w(self):
                     self._error = None
             """},
        "writes shared `self._error` outside any lock scope",
    ),
}


@pytest.mark.parametrize("case", sorted(BAD_TREES))
def test_cli_exits_nonzero_on_a_bad_fixture(case, tmp_path):
    args, files, phrase = BAD_TREES[case]
    _write_tree(tmp_path, files)
    proc = _cli(*args, "--root", str(tmp_path))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert phrase in proc.stdout, proc.stdout
    assert "1 finding(s)" in proc.stderr, proc.stderr


CLEAN_TREES = {
    "condition_wait": """\
        import threading


        class Q:
            def __init__(self):
                self._cv = threading.Condition()
                self._items = []

            def take(self):
                with self._cv:
                    while not self._items:
                        self._cv.wait()
                    return self._items.pop()
        """,
    "dtype_cast": """\
        import torch


        def widen(state, lock):
            with lock:
                return state.acc.to(torch.int64)
        """,
    "functools_reduce": """\
        import functools
        import operator


        def product(xs, lock):
            with lock:
                return functools.reduce(operator.mul, xs, 1)
        """,
}


@pytest.mark.parametrize("case", sorted(CLEAN_TREES))
def test_cli_leaves_a_clean_fixture_alone(case, tmp_path):
    _write_tree(tmp_path, {"w.py": CLEAN_TREES[case]})
    proc = _cli("--pass", "locks", "--root", str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert lock_lint.lint_file(str(tmp_path / "w.py")) == []


# -- the baseline -------------------------------------------------------------

def test_a_stale_baseline_entry_is_itself_a_finding():
    ghost = ("locks", "loghisto_tpu_torch/nope.py", "Gone.fn",
             "blocking-under-lock:cpu", "was fine once")
    survivors = apply_baseline([], baseline=[ghost])
    assert len(survivors) == 1
    stale = survivors[0]
    assert (stale.pass_name, stale.detail, stale.path) == (
        "baseline", "stale-suppression",
        "loghisto_tpu_torch/analysis/baseline.py")
    real = Finding("locks", "loghisto_tpu_torch/nope.py", 3, "Gone.fn",
                   "blocking-under-lock:cpu", "whatever")
    assert apply_baseline([real], baseline=[ghost]) == []
    # a pass that did not run cannot make its entries stale
    assert apply_baseline([], baseline=[ghost], passes=("imports",)) == []


def test_every_baseline_entry_names_its_reason():
    keys = [entry[:4] for entry in baseline_mod.BASELINE]
    assert len(keys) == len(set(keys))
    for entry in baseline_mod.BASELINE:
        assert len(entry) == 5 and entry[0] in ("imports", "locks",
                                                "programs")
        assert (REPO / entry[1]).is_file(), entry
        assert entry[4].strip(), entry


# -- the blocking list covers the port's collectives --------------------------

def _mesh_collective_functions() -> set:
    """Module-level functions of ``parallel/mesh.py`` whose body calls a
    ``dist.<collective>``, or such a function of the module."""
    tree = ast.parse(MESH.read_text())
    direct = set(lock_lint.DIST_COLLECTIVES) | set(
        lock_lint.QUALIFIED_COLLECTIVES)
    calls = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            names = set()
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                f = sub.func
                if (isinstance(f, ast.Attribute)
                        and isinstance(f.value, ast.Name)
                        and f.value.id == "dist" and f.attr in direct):
                    names.add("<dist>")
                elif isinstance(f, ast.Name):
                    names.add(f.id)
            calls[node.name] = names
    found = {n for n, c in calls.items() if "<dist>" in c}
    grew = True
    while grew:
        more = {n for n, c in calls.items() if c & found} - found
        found |= more
        grew = bool(more)
    return found


def test_every_collective_helper_of_the_mesh_is_blocking():
    found = _mesh_collective_functions()
    assert {"mesh_reduce", "gather_parts", "reduce_parts", "host_gather",
            "agreed", "gather_objects", "gather_rows",
            "all_gather_objects", "gather_triples",
            "ragged_gather_triples", "_all_to_all_rows",
            "fold_rows"} <= found
    missing = sorted(found - set(lock_lint.BLOCKING_CALLS))
    assert not missing, missing
    for name in lock_lint.DIST_COLLECTIVES:
        assert lock_lint.BLOCKING_CALLS[name] == "collective"
    assert "wait" not in lock_lint.BLOCKING_CALLS


# -- parity with the JAX package's analyzer ------------------------------------

PARITY_SOURCE = """\
    import socket
    import threading

    import jax


    class Mixed:
        def __init__(self):
            self._lock = threading.Lock()
            self._xfer_cv = threading.Condition()
            self.sock = socket.socket()

        def start(self):
            threading.Thread(target=self._loop, daemon=True).start()

        def commit(self, carry):
            with self._lock:
                jax.block_until_ready(carry)
                return jax.device_get(carry)

        def talk(self):
            with self._xfer_cv:
                self.sock.sendall(b"x")
                self._xfer_cv.wait()
            return self.sock.recv(4)

        def _loop(self):
            self._busy = True
            with self._lock:
                self._seen = 1

            def nested():
                with self._lock:
                    self.sock.connect(("localhost", 1))
            return nested
"""


def test_the_lock_lint_matches_the_reference_on_its_rules(tmp_path):
    from loghisto_tpu.analysis import lock_lint as ref_lock_lint

    assert lock_lint.REFERENCE_BLOCKING_CALLS == ref_lock_lint.BLOCKING_CALLS
    _write_tree(tmp_path, {"mixed.py": PARITY_SOURCE})
    files = [tmp_path / "mixed.py",
             REPO / "tests" / "analysis_fixtures" / "bad_lock_pkg"
             / "worker.py",
             REPO / "loghisto_tpu_torch" / "parallel" / "aggregator.py",
             REPO / "loghisto_tpu_torch" / "window" / "store.py"]
    for path in files:
        ours = lock_lint.lint_file(
            str(path), table=lock_lint.REFERENCE_BLOCKING_CALLS)
        theirs = ref_lock_lint.lint_file(str(path))
        assert [(f.key(), f.line, f.reason) for f in ours] == [
            (f.key(), f.line, f.reason) for f in theirs], path
    assert len(lock_lint.lint_file(
        str(tmp_path / "mixed.py"),
        table=lock_lint.REFERENCE_BLOCKING_CALLS)) == 5


def test_apply_baseline_matches_the_reference():
    from loghisto_tpu.analysis import Finding as RefFinding
    from loghisto_tpu.analysis import apply_baseline as ref_apply

    rows = [("locks", "a.py", 3, "A.f", "blocking-under-lock:cpu", "r1"),
            ("locks", "a.py", 9, "A.f", "blocking-under-lock:cpu", "r2"),
            ("imports", "b.py", 1, "b", "torch-import:torch", "r3"),
            ("locks", "c.py", 5, "C.g", "unlocked-worker-write:_x", "r4")]
    base = [("locks", "a.py", "A.f", "blocking-under-lock:cpu", "pinned"),
            ("locks", "z.py", "Z.h", "blocking-under-lock:item", "stale"),
            ("imports", "y.py", "y", "torch-import:torch", "other pass")]

    def norm(findings):
        return sorted((f.pass_name, f.path.split("/")[-1], f.line, f.scope,
                       f.detail, f.reason) for f in findings)

    for passes in (None, ("locks",), ("imports", "locks")):
        ours = apply_baseline([Finding(*r) for r in rows], base, passes)
        theirs = ref_apply([RefFinding(*r) for r in rows], base, passes)
        assert norm(ours) == norm(theirs), passes
