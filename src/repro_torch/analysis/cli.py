"""The port's metrolint CLI (``python -m repro_torch.analysis``).

Exit status is the contract a pre-commit check relies on:

  * ``0`` — no findings outside the baseline, no stale suppressions;
  * ``1`` — new findings (fix them or suppress WITH A REASON), or stale
    suppressions (the finding is gone — delete its baseline entry);
  * ``2`` — usage errors / unreadable baseline.

``--write-baseline`` rewrites the baseline to exactly the current finding
set, preserving reasons of entries that survive; fresh entries get a
placeholder reason that a human must replace before committing.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from . import checks as _checks  # noqa: F401  (registers the checks)
from .core import (BASELINE_NAME, all_checks, apply_baseline, load_baseline,
                   run_checks, write_baseline)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch.analysis",
        description="metrolint for the port: static invariant checks on "
                    "src/repro_torch/ and tests/test_torch_*.py")
    p.add_argument("--root", default=".",
                   help="repo root to scan (default: cwd)")
    p.add_argument("--baseline", default=None,
                   help=f"baseline path (default: <root>/{BASELINE_NAME})")
    p.add_argument("--checks", default=None,
                   help="comma-separated subset of check ids")
    p.add_argument("--list-checks", action="store_true",
                   help="list registered checks and exit")
    p.add_argument("--write-baseline", action="store_true",
                   help="rewrite the baseline to the current finding set")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit machine-readable JSON instead of text")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_checks:
        for cid, doc in all_checks().items():
            print(f"{cid}: {doc}")
        return 0

    root = Path(args.root).resolve()
    if not root.is_dir():
        print(f"metrolint: root {root} is not a directory", file=sys.stderr)
        return 2
    baseline_path = (Path(args.baseline) if args.baseline
                     else root / BASELINE_NAME)
    selected = ([c.strip() for c in args.checks.split(",") if c.strip()]
                if args.checks else None)

    try:
        findings = run_checks(root, selected)
    except ValueError as e:
        print(f"metrolint: {e}", file=sys.stderr)
        return 2

    try:
        baseline = load_baseline(baseline_path)
    except (ValueError, KeyError, json.JSONDecodeError) as e:
        print(f"metrolint: bad baseline: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        write_baseline(baseline_path, findings, existing=baseline)
        print(f"metrolint: wrote {len(findings)} suppression(s) to "
              f"{baseline_path}")
        return 0

    new, suppressed, stale = apply_baseline(findings, baseline)

    if args.as_json:
        print(json.dumps({
            "new": [vars(f) for f in new],
            "suppressed": [vars(f) for f in suppressed],
            "stale": [vars(s) for s in stale],
        }, indent=1))
        return 1 if (new or stale) else 0

    for f in new:
        print(f.render())
    for s in stale:
        print(f"stale suppression: {s.fingerprint} (reason was: "
              f"{s.reason!r}) — the finding is gone, delete the entry")
    summary = (f"metrolint: {len(new)} new finding(s), "
               f"{len(suppressed)} suppressed, {len(stale)} stale")
    print(summary, file=sys.stderr if (new or stale) else sys.stdout)
    return 1 if (new or stale) else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
