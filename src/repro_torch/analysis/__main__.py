"""Static contract verification gate (``scripts/analyze.py``).

Runs ``repro_torch.analysis`` over the static plan matrix -- local tiers x
fusion x dtype, donation, reorder and dedup cells, and ``LocalMesh((8,))``
and ``LocalMesh((4, 2))`` plans -- and the source rules over
``src/repro_torch/``, without executing a plan (the donation rule's
replays on a card apart).  The rule catalog is the docstring of
``repro_torch.analysis``.

  python -m repro_torch.analysis --strict     # exit 1 on any error finding
  python -m repro_torch.analysis --selftest   # every rule must catch its plant
  python -m repro_torch.analysis --json       # machine-readable report
  python -m repro_torch.analysis --markdown   # rendered report
  python -m repro_torch.analysis --device cpu # the torch tier on the CPU

``--strict`` is the gate: zero error-severity findings.  ``--selftest``
first seeds one known violation per rule and fails if any rule misses
its plant -- the gate that keeps the gate honest.
"""

from __future__ import annotations

import argparse


def selftest() -> int:
    from repro_torch.analysis.selftest import run_selftest
    detected, _ = run_selftest()
    missed = sorted(r for r, ok in detected.items() if not ok)
    for rule in sorted(detected):
        print(f"  {rule:20s} {'DETECTED' if detected[rule] else 'MISSED'}")
    if missed:
        print(f"analysis --selftest: FAILED ({len(missed)} rule(s) missed "
              f"their plant: {', '.join(missed)})")
        return 1
    print(f"analysis --selftest: OK ({len(detected)} rules caught their "
          "plants; suppression pragma honored)")
    return 0


def main(argv=None) -> int:
    from repro_torch.analysis import run_matrix
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any error-severity finding")
    ap.add_argument("--selftest", action="store_true",
                    help="seed one violation per rule first; fail on any "
                         "miss")
    ap.add_argument("--json", action="store_true", help="JSON report")
    ap.add_argument("--markdown", action="store_true",
                    help="markdown report")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the matrix's plans are built (default "
                         "cuda, which needs a card)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    rc = selftest() if args.selftest else 0
    report, cells = run_matrix(args.device, verbose=args.verbose)
    if args.json:
        print(report.to_json())
    elif args.markdown:
        print(report.to_markdown())
    elif report.findings:
        print(report.render())
    counts = report.counts()
    ok = report.ok(strict=True)
    print(f"analysis: {'OK' if ok else 'FAILED'} ({cells} plan cells on "
          f"{args.device}, {counts['error']} error(s), "
          f"{counts['warning']} warning(s), {counts['info']} info)")
    if args.strict and not ok:
        rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
