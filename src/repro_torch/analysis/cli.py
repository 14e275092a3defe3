"""Command line of the port's ``simplexlint``.

    python -m repro_torch.analysis.cli [--json] [--passes a,b] [--list] [--root DIR]

Text findings one a line by default, the JSON report with ``--json``;
exit 0 when every pass is clean, 1 on a finding, 2 on an unknown pass.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import Optional, Sequence

from . import ast_passes, halo_passes, schedule_passes  # noqa: F401 (registration)
from .registry import findings_to_json, get_pass, registered_passes, run_passes

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the registry (or the named passes) and report; the exit code."""
    ap = argparse.ArgumentParser(prog="simplexlint",
                                 description="static checks of the port's schedules, "
                                 "kernels and house rules")
    ap.add_argument("--root", default=None,
                    help="repository root (default: the one this package is in)")
    ap.add_argument("--passes", default=None, help="comma-separated passes (default: all)")
    ap.add_argument("--json", action="store_true", help="the JSON report")
    ap.add_argument("--list", action="store_true", dest="list_passes",
                    help="list the passes and exit")
    args = ap.parse_args(argv)
    root = (pathlib.Path(args.root).resolve() if args.root
            else pathlib.Path(__file__).resolve().parents[3])
    names = ([p.strip() for p in args.passes.split(",") if p.strip()] if args.passes
             else list(registered_passes()))
    unknown = [n for n in names if n not in registered_passes()]
    if unknown:
        print(f"simplexlint: unknown pass(es) {unknown}; registered: "
              f"{', '.join(registered_passes())}", file=sys.stderr)
        return 2
    if args.list_passes:
        for name in names:
            p = get_pass(name)
            print(f"{name:22s} {p.family:8s} {p.description}")
        return 0
    findings = run_passes(root, passes=names)
    if args.json:
        print(findings_to_json(findings, names))
    else:
        for f in findings:
            print(f.format())
        print(f"simplexlint: {len(findings)} finding(s) from {len(names)} pass(es)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
