"""Differential run diffing CLI: ``python -m repro_torch.launch.obsdiff A B``.

Counterpart of ``repro/launch/obsdiff.py``, whose code this is, with its
imports pointed into ``repro_torch``; ``tests/test_torch_obsdiff.py``
holds the two equal.

A and B are any two run artifacts — runtime report JSON, Chrome-trace
export, metrics/monitor JSONL, or ``BENCH_*.json`` — optionally pinned to
a committed revision with ``PATH@GITREV``:

  python -m repro_torch.launch.obsdiff BENCH_engine.json@HEAD~2 BENCH_engine.json
  python -m repro_torch.launch.obsdiff run_a.trace.json run_b.trace.json --top 20
  python -m repro_torch.launch.obsdiff a.monitor.jsonl b.monitor.jsonl --match p99

Output: per-cause stall-ledger delta, per-quantile distribution shift
(when both sides carry streaming-monitor summaries), and a top-K scalar
regression table ranked by relative change.  Stdlib-only; runs without
torch.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.diffing import diff_runs, format_diff, load_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.obsdiff",
        description="diff two runtime reports / traces / metric JSONL / "
                    "BENCH_*.json (optionally PATH@GITREV)")
    ap.add_argument("a", help="baseline run artifact")
    ap.add_argument("b", help="candidate run artifact")
    ap.add_argument("--top", type=int, default=12,
                    help="rows in the regression attribution table")
    ap.add_argument("--match", default=None,
                    help="only diff scalar metrics whose path contains this")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the machine-readable diff here")
    args = ap.parse_args(argv)

    try:
        view_a = load_run(args.a)
        view_b = load_run(args.b)
    except (OSError, ValueError) as e:
        print(f"obsdiff: {e}", file=sys.stderr)
        return 2

    if args.match:
        view_a.scalars = {k: v for k, v in view_a.scalars.items()
                          if args.match in k}
        view_b.scalars = {k: v for k, v in view_b.scalars.items()
                          if args.match in k}

    diff = diff_runs(view_a, view_b, top_k=args.top)
    print(format_diff(diff))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(diff, f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
