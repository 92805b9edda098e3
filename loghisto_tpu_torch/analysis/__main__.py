"""CLI gate: ``python -m loghisto_tpu_torch.analysis [--pass NAME ...]``.

Runs the three passes (import-graph lint, concurrency lint, program
registry) over ``loghisto_tpu_torch/``, applies the reviewed baseline,
prints one ``file:line [pass] scope: reason`` line per surviving
finding, and exits nonzero if any survive.  It needs no card: the
lazy-surface check and the programs pass import the port's packages
(and so torch), and the programs pass runs every registry step on the
CPU, its mesh entries on four gloo ranks (``--no-mesh`` skips them).

``--root DIR --package NAME`` lints a fixture tree instead (the
imports pass's three rules over package NAME under DIR, the locks pass
over DIR); ``--frontier MODULE`` names that tree's torch-free frontier;
``--programs FILE`` audits the specs of FILE's ``PROGRAMS`` tuple
instead of the registry.  No baseline applies to a fixture.  ``--list``
prints each registry entry, its contract, its factory and, for a
one-device entry, its aten op census, and exits.
"""

from __future__ import annotations

import argparse
import os
import sys

PASSES = ("imports", "locks", "programs")


def _load_programs(path: str) -> tuple:
    """The ``PROGRAMS`` tuple of the Python file at ``path``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_audited_programs", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return tuple(module.PROGRAMS)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m loghisto_tpu_torch.analysis",
        description="the port's static analyzer (import lint, lock lint, "
                    "program registry)",
    )
    parser.add_argument(
        "--pass", dest="passes", action="append", choices=PASSES,
        help="run only the named pass (repeatable; default: all)",
    )
    # Fixture-tree overrides (tests/test_torch_analysis.py drives the CLI
    # against trees written into a temporary directory; baseline
    # suppression is skipped when any is set):
    parser.add_argument(
        "--root", metavar="DIR",
        help="lint DIR instead of the repository (imports and locks)",
    )
    parser.add_argument(
        "--package", metavar="NAME",
        help="package name under --root (imports pass)",
    )
    parser.add_argument(
        "--frontier", action="append", metavar="MODULE",
        help="override the torch-free frontier module list (imports pass)",
    )
    parser.add_argument(
        "--programs", metavar="FILE",
        help="audit the specs of FILE's PROGRAMS tuple (programs pass)",
    )
    parser.add_argument(
        "--no-mesh", action="store_true",
        help="skip the registry's mesh entries (programs pass)",
    )
    parser.add_argument(
        "--list", action="store_true",
        help="print each registry entry, its contract and factory, and exit",
    )
    args = parser.parse_args(argv)
    if args.list:
        from loghisto_tpu_torch.analysis import program_audit

        for spec in program_audit.PROGRAMS:
            print(program_audit.describe(spec, census=not spec.mesh))
        return 0
    selected = tuple(args.passes) if args.passes else (
        PASSES[:2] if args.root else PASSES)
    overridden = bool(args.root or args.frontier or args.programs)
    if args.root and not args.package and "imports" in selected:
        parser.error("--root needs --package for the imports pass")

    from loghisto_tpu_torch.analysis import apply_baseline
    from loghisto_tpu_torch.analysis import baseline as baseline_mod

    findings = []
    baseline = list(baseline_mod.BASELINE)
    for name in selected:
        if name == "imports":
            from loghisto_tpu_torch.analysis import import_lint

            kw = {}
            if args.root:
                root = os.path.abspath(args.root)
                kw = dict(package_root=os.path.join(root, args.package),
                          package=args.package, repo_root=root, frontier=())
            if args.frontier:
                kw["frontier"] = tuple(args.frontier)
            findings.extend(import_lint.run(**kw))
        elif name == "locks":
            from loghisto_tpu_torch.analysis import lock_lint

            findings.extend(
                lock_lint.run(os.path.abspath(args.root)) if args.root
                else lock_lint.run()
            )
        elif name == "programs":
            from loghisto_tpu_torch.analysis import program_audit

            if args.programs:
                for spec in _load_programs(os.path.abspath(args.programs)):
                    findings.extend(program_audit.audit_spec(spec))
            else:
                findings.extend(program_audit.audit_all(
                    mesh=not args.no_mesh))
                if args.no_mesh:  # the mesh entries' pins did not run
                    skipped = set(program_audit.mesh_names())
                    baseline = [e for e in baseline if not (
                        e[0] == "programs" and e[2] in skipped)]

    survivors = (list(findings) if overridden
                 else apply_baseline(findings, baseline, passes=selected))
    for finding in sorted(survivors, key=lambda f: (f.path, f.line)):
        print(finding.render())
    suppressed = len(findings) - sum(
        1 for f in survivors if f.pass_name != "baseline"
    )
    print(
        f"analysis: {len(survivors)} finding(s), {suppressed} "
        f"baseline-suppressed, passes={','.join(selected)}",
        file=sys.stderr,
    )
    return 1 if survivors else 0


if __name__ == "__main__":
    raise SystemExit(main())
