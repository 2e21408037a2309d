"""repro_torch.launch.analyze — verify plan artifacts and schedule traces offline.

Counterpart of ``repro/launch/analyze.py``, whose code this is, with its
imports pointed into ``repro_torch``; ``tests/test_torch_obsdiff.py``
holds the two equal.

Usage:
  python -m repro_torch.launch.analyze PATH [PATH ...]

Each PATH is classified by shape, not extension:

  * Chrome trace JSON (a ``traceEvents`` list, as written by
    ``repro_torch.obs.write_trace``) — swept by the event-log race detector
    (``repro_torch.analyze.schedule_check``).
  * Plan artifact JSON (a versioned ``MemoryProgram`` payload, as written
    by ``PlanCache.store``) — swept by the static plan verifier
    (``repro_torch.analyze.plan_check``).

Prints one certificate summary per file and exits nonzero if any invariant
failed.  Neither kind imports torch; plan artifacts lazily import the
plan layer only when one is actually given.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analyze import check_view, verify_program, view_from_trace


def classify(payload: dict) -> str:
    if isinstance(payload.get("traceEvents"), list):
        return "trace"
    if "pool_plans" in payload or "swap_summaries" in payload:
        return "plan"
    return "unknown"


def verify_path(path: str):
    """(kind, Certificate | None, error | None) for one input file."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError) as e:
        return "unreadable", None, str(e)
    if not isinstance(payload, dict):
        return "unknown", None, "not a JSON object"
    kind = classify(payload)
    if kind == "trace":
        return kind, check_view(view_from_trace(payload, source=path)), None
    if kind == "plan":
        from repro_torch.plan.artifact import program_from_json

        try:
            program = program_from_json(payload)
        except (KeyError, TypeError, ValueError) as e:
            return kind, None, f"unparseable plan artifact: {e}"
        return kind, verify_program(program), None
    return kind, None, "neither a Chrome trace nor a plan artifact"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="repro_torch.launch.analyze",
        description="Statically verify plan artifacts and schedule traces.",
    )
    parser.add_argument("paths", nargs="+", metavar="PATH",
                        help="plan artifact or Chrome trace JSON")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="one verdict line per file, no per-invariant detail")
    args = parser.parse_args(argv)

    failures = 0
    for path in args.paths:
        kind, cert, err = verify_path(path)
        if cert is None:
            failures += 1
            print(f"FAIL {path}: {err}")
            continue
        verdict = "ok  " if cert.ok else "FAIL"
        if not cert.ok:
            failures += 1
        print(f"{verdict} {path} [{kind}]")
        if not args.quiet:
            for line in cert.summary_lines():
                print(f"     {line}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
