"""CLI gate: ``python -m loghisto_tpu_torch.analysis [--pass NAME ...]``.

Runs the two static passes (import-graph lint, concurrency lint) over
``loghisto_tpu_torch/``, applies the reviewed baseline, prints one
``file:line [pass] scope: reason`` line per surviving finding, and
exits nonzero if any survive.  It needs no card: only the imports
pass's lazy-surface check imports the port's packages (and so torch).

``--root DIR --package NAME`` lints a fixture tree instead (the
imports pass's three rules over package NAME under DIR, the locks pass
over DIR); ``--frontier MODULE`` names that tree's torch-free frontier.
No baseline applies to a fixture tree.
"""

from __future__ import annotations

import argparse
import os
import sys

PASSES = ("imports", "locks")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m loghisto_tpu_torch.analysis",
        description="the port's static analyzer (import lint, lock lint)",
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
    args = parser.parse_args(argv)
    selected = tuple(args.passes) if args.passes else PASSES
    overridden = bool(args.root or args.frontier)
    if args.root and not args.package and "imports" in selected:
        parser.error("--root needs --package for the imports pass")

    from loghisto_tpu_torch.analysis import apply_baseline

    findings = []
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

    survivors = (list(findings) if overridden
                 else apply_baseline(findings, passes=selected))
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
