"""Static contract analyzer of the port (counterpart of
``loghisto_tpu/analysis``): prove the port's layering, locking and
per-step device invariants once, centrally, with no card.

Three passes, one gate:

  * ``import_lint`` — AST module graph enforcing the port's layering:
    nothing in the package imports the JAX stack (``jax``, ``jaxlib``)
    or the reference package ``loghisto_tpu``, anywhere, function
    bodies included; the torch-free frontier (federation emitter, label
    model, span ring, host metrics, the submitter and this analyzer)
    must not transitively reach torch or triton at import time; and the
    PEP 562 lazy surfaces must resolve every advertised name.
  * ``lock_lint``   — AST concurrency discipline: no blocking device
    readback, device sync, collective or socket op while holding a lock,
    and thread entry points must take a lock before writing shared
    attributes.
  * ``program_audit`` — the program registry: every device step run
    once at a small seeded geometry under a recorder, its kernel
    wrapper entries, in-place carries, collectives (on a (2, 2) mesh of
    four gloo ranks), int32 accumulation, forbidden dense shapes and
    freedom from host syncs held to its contract.

Reviewed exceptions are pinned (with reasons) in ``analysis/baseline.py``.
``python -m loghisto_tpu_torch.analysis`` runs the three passes and
exits nonzero with per-finding ``file:line reason`` output;
``tests/test_torch_analysis.py`` and ``tests/test_torch_contracts.py``
run the same passes inside tier-1.

Every module of this package loads without torch: the lazy-surface
check and the program auditor import torch inside their functions, and
this ``__init__`` does not import ``program_audit``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Sequence

# Repo root (the directory holding loghisto_tpu_torch/): every finding
# path is reported relative to it so baseline keys survive checkouts.
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

BASELINE_PATH = "loghisto_tpu_torch/analysis/baseline.py"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation.

    ``key()`` (pass, path, scope, detail) deliberately excludes the line
    number so baseline suppressions survive unrelated edits to the same
    file — the scope (qualified function / module name) and detail (the
    violating construct) pin the finding, the line is presentation.
    """

    pass_name: str   # "imports" | "locks" | "programs" | "baseline"
    path: str        # repo-relative file
    line: int
    scope: str       # qualified function / module
    detail: str      # machine-ish identifier of the violated rule
    reason: str      # human sentence naming the violated contract

    def key(self) -> tuple:
        return (self.pass_name, self.path, self.scope, self.detail)

    def render(self) -> str:
        return (
            f"{self.path}:{self.line} [{self.pass_name}] {self.scope}: "
            f"{self.reason}"
        )


def relpath(path: str) -> str:
    """Normalize an absolute path to the repo-relative finding path."""
    ap = os.path.abspath(path)
    if ap.startswith(REPO_ROOT + os.sep):
        return os.path.relpath(ap, REPO_ROOT)
    return path


def apply_baseline(
    findings: Iterable[Finding],
    baseline: Sequence[tuple] | None = None,
    passes: Sequence[str] | None = None,
) -> list[Finding]:
    """Suppress findings pinned in the baseline; surface stale baseline
    entries (suppressions that no longer match anything) as findings of
    their own so the table cannot rot.  ``passes`` limits staleness
    detection to the passes that actually ran (a locks suppression is
    not stale just because only the imports pass was selected)."""
    from loghisto_tpu_torch.analysis import baseline as baseline_mod

    entries = baseline_mod.BASELINE if baseline is None else baseline
    if passes is not None:
        entries = [e for e in entries if e[0] in passes]
    by_key = {tuple(e[:4]): e for e in entries}
    used: set[tuple] = set()
    kept: list[Finding] = []
    for f in findings:
        if f.key() in by_key:
            used.add(f.key())
        else:
            kept.append(f)
    for key, entry in by_key.items():
        if key not in used:
            kept.append(Finding(
                pass_name="baseline",
                path=BASELINE_PATH,
                line=1,
                scope=":".join(key[:2]),
                detail="stale-suppression",
                reason=(
                    f"baseline entry {key!r} no longer matches any "
                    f"finding — remove it (was: {entry[4]!r})"
                ),
            ))
    return kept


__all__ = ["Finding", "REPO_ROOT", "apply_baseline", "relpath"]
