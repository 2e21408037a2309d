"""Differential run analysis: two runs in, ranked regression story out.

Counterpart of ``repro/obs/diffing.py``, whose code this is, with its
imports pointed into ``repro_torch``; ``tests/test_torch_obsdiff.py``
holds the two equal.

The unit of comparison is a ``RunView`` — label + flat numeric scalars +
aggregate stall-attribution ledger + streaming-quantile summary — and
``load_run`` builds one from any of the artifact shapes this repo emits:

  runtime report JSON      a saved ``RuntimeReport.as_dict()`` (has
                           ``tenants``); the ledger aggregates per-tenant
                           ``attribution`` buckets
  trace JSON               Chrome-trace export (has ``traceEvents``):
                           reads ``otherData`` — metrics, embedded report,
                           and the monitor quantile summary when present
  metrics JSONL            ``MetricsRegistry.append_jsonl`` /
                           ``--monitor-out`` files: the *last* record wins
  BENCH_*.json             benchmark reports: numeric scalars flattened to
                           dotted paths (same scheme as bench_history)
  PATH@GITREV              any of the above at a committed revision, via
                           ``git show`` (e.g. ``BENCH_engine.json@HEAD~2``)

``diff_runs`` then produces three tables: per-cause ledger delta,
per-quantile distribution shift, and a top-K scalar regression attribution
table ranked by relative change.  Stdlib-only on purpose:
``python -m repro_torch.launch.obsdiff`` runs where torch cannot import.
"""

from __future__ import annotations

import json
import os
import subprocess

# Ledger keys excluded from the sums-to-overhead invariant; kept in the
# delta table (they are exactly the headline aggregates) but flagged.
LEDGER_INFORMATIONAL = {"overhead_s", "queue_wait_s", "renegotiation_solve_s"}


class RunView:
    """One run, normalized for diffing."""

    __slots__ = ("label", "kind", "scalars", "ledger", "quantiles")

    def __init__(self, label: str, kind: str, scalars: dict,
                 ledger: "dict | None" = None, quantiles: "dict | None" = None):
        self.label = label
        self.kind = kind
        self.scalars = scalars
        self.ledger = ledger
        self.quantiles = quantiles

    def as_dict(self) -> dict:
        return {"label": self.label, "kind": self.kind, "scalars": self.scalars,
                "ledger": self.ledger, "quantiles": self.quantiles}


def flatten(obj, prefix: str = "", depth: int = 4):
    """Yield (dotted-path, value) for numeric/bool scalars up to ``depth``."""
    if isinstance(obj, bool) or isinstance(obj, (int, float)):
        yield prefix, float(obj)
        return
    if depth <= 0 or not isinstance(obj, dict):
        return
    for k, v in obj.items():
        if k == "_meta":
            continue
        path = f"{prefix}.{k}" if prefix else str(k)
        yield from flatten(v, path, depth - 1)


def _aggregate_ledger(report: dict) -> "dict | None":
    """Sum per-tenant attribution buckets across a runtime report."""
    out: dict[str, float] = {}
    found = False
    for t in report.get("tenants", ()):
        ledger = t.get("attribution")
        if not isinstance(ledger, dict):
            continue
        found = True
        for cause, v in ledger.items():
            if isinstance(v, (int, float)):
                out[cause] = out.get(cause, 0.0) + float(v)
    return dict(sorted(out.items())) if found else None


def _view_from_report(label: str, report: dict) -> RunView:
    return RunView(label, "report", dict(flatten(report)),
                   ledger=_aggregate_ledger(report))


def _view_from_trace(label: str, trace: dict) -> RunView:
    other = trace.get("otherData", {})
    scalars = {f"metrics.{k}": float(v)
               for k, v in other.get("metrics", {}).items()
               if isinstance(v, (int, float))}
    ledger, quantiles = None, None
    report = other.get("report")
    if isinstance(report, dict):
        scalars.update(dict(flatten(report, prefix="report")))
        ledger = _aggregate_ledger(report)
    monitor = other.get("monitor")
    if isinstance(monitor, dict):
        quantiles = monitor.get("quantiles")
    return RunView(label, "trace", scalars, ledger=ledger, quantiles=quantiles)


def _view_from_jsonl(label: str, text: str) -> RunView:
    record = None
    for line in text.splitlines():
        line = line.strip()
        if line:
            record = json.loads(line)
    if record is None:
        raise ValueError(f"{label}: empty JSONL file")
    scalars = {f"metrics.{k}": float(v)
               for k, v in record.get("metrics", {}).items()
               if isinstance(v, (int, float))}
    monitor = record.get("monitor")
    quantiles = monitor.get("quantiles") if isinstance(monitor, dict) else None
    return RunView(label, "jsonl", scalars, quantiles=quantiles)


def classify(payload) -> str:
    if isinstance(payload, dict):
        if "traceEvents" in payload:
            return "trace"
        if "tenants" in payload:
            return "report"
        return "bench"
    raise ValueError("unsupported run payload (expected a JSON object)")


def view_from_payload(label: str, payload: dict) -> RunView:
    kind = classify(payload)
    if kind == "trace":
        return _view_from_trace(label, payload)
    if kind == "report":
        return _view_from_report(label, payload)
    view = RunView(label, "bench", dict(flatten(payload)))
    # A bench cell that embedded a monitor summary (the churn SLO cell
    # does) contributes its quantile streams too.
    q = _find_quantiles(payload)
    if q is not None:
        view.quantiles = q
    return view


def _find_quantiles(obj, depth: int = 3):
    """First ``{"quantiles": {stream: {stat: num}}}`` block, depth-first."""
    if not isinstance(obj, dict) or depth < 0:
        return None
    q = obj.get("quantiles")
    if isinstance(q, dict) and q and all(isinstance(v, dict) for v in q.values()):
        return q
    for v in obj.values():
        found = _find_quantiles(v, depth - 1)
        if found is not None:
            return found
    return None


def _git_show(rev: str, relpath: str, repo: "str | None" = None) -> str:
    out = subprocess.run(
        ["git", "show", f"{rev}:{relpath}"], capture_output=True, text=True,
        cwd=repo or os.getcwd(), timeout=60)
    if out.returncode != 0:
        raise ValueError(f"git show {rev}:{relpath}: {out.stderr.strip()}")
    return out.stdout


def load_run(spec: str, repo: "str | None" = None) -> RunView:
    """Build a RunView from a path, or ``PATH@GITREV`` for a committed
    revision of the file (resolved relative to ``repo`` / the cwd)."""
    path, _, rev = spec.partition("@")
    if rev:
        text = _git_show(rev, path, repo)
        label = spec
    else:
        with open(path) as f:
            text = f.read()
        label = path
    if path.endswith(".jsonl"):
        return _view_from_jsonl(label, text)
    try:
        payload = json.loads(text)
    except ValueError:
        return _view_from_jsonl(label, text)  # JSONL without the extension
    return view_from_payload(label, payload)


# ---------------------------------------------------------------- diffing

def _rel(a: float, b: float) -> float:
    if a == 0.0:
        return 0.0 if b == 0.0 else float("inf")
    return (b - a) / abs(a)


def diff_runs(a: RunView, b: RunView, top_k: int = 12) -> dict:
    """The three diff tables; every list pre-ranked, most movement first."""
    ledger_delta = []
    if a.ledger is not None and b.ledger is not None:
        causes = sorted(dict.fromkeys(list(a.ledger) + list(b.ledger)))
        for cause in causes:
            va, vb = a.ledger.get(cause, 0.0), b.ledger.get(cause, 0.0)
            ledger_delta.append({
                "cause": cause, "a": va, "b": vb, "delta": vb - va,
                "informational": cause in LEDGER_INFORMATIONAL})
        ledger_delta.sort(key=lambda r: (-abs(r["delta"]), r["cause"]))

    quantile_shift = []
    if a.quantiles is not None and b.quantiles is not None:
        streams = sorted(k for k in a.quantiles if k in b.quantiles)
        for stream in streams:
            qa, qb = a.quantiles[stream], b.quantiles[stream]
            for stat in sorted(k for k in qa if k in qb):
                va, vb = qa[stat], qb[stat]
                if not isinstance(va, (int, float)) or not isinstance(vb, (int, float)):
                    continue
                quantile_shift.append({
                    "stream": stream, "stat": stat, "a": va, "b": vb,
                    "delta": vb - va, "rel": _rel(va, vb)})
        quantile_shift.sort(
            key=lambda r: (-abs(r["rel"]), r["stream"], r["stat"]))

    rows = []
    for key in sorted(k for k in a.scalars if k in b.scalars):
        va, vb = a.scalars[key], b.scalars[key]
        if va == vb:
            continue
        rows.append({"metric": key, "a": va, "b": vb, "delta": vb - va,
                     "rel": _rel(va, vb)})
    rows.sort(key=lambda r: (-abs(r["rel"]), r["metric"]))
    only_a = sorted(k for k in a.scalars if k not in b.scalars)
    only_b = sorted(k for k in b.scalars if k not in a.scalars)

    return {
        "a": a.label, "b": b.label,
        "ledger_delta": ledger_delta,
        "quantile_shift": quantile_shift,
        "top_regressions": rows[:top_k],
        "n_changed": len(rows),
        "only_in_a": only_a,
        "only_in_b": only_b,
    }


def _fmt(v: float) -> str:
    if v != v or abs(v) == float("inf"):
        return "new" if v > 0 else str(v)
    if v == 0:
        return "0"
    if abs(v) >= 1000:
        return f"{v:,.0f}"
    if abs(v) >= 1:
        return f"{v:.4g}"
    return f"{v:.3e}"


def format_diff(diff: dict) -> str:
    """Human-readable rendering of a ``diff_runs`` result."""
    lines = [f"obsdiff: A = {diff['a']}", f"         B = {diff['b']}"]
    if diff["ledger_delta"]:
        lines.append("")
        lines.append("per-cause ledger delta (seconds, B - A):")
        for r in diff["ledger_delta"]:
            note = "  [informational]" if r["informational"] else ""
            lines.append(f"  {r['cause']:28s} {_fmt(r['a']):>12s} -> "
                         f"{_fmt(r['b']):>12s}  d={_fmt(r['delta']):>10s}{note}")
    if diff["quantile_shift"]:
        lines.append("")
        lines.append("quantile distribution shift (B - A):")
        for r in diff["quantile_shift"]:
            lines.append(
                f"  {r['stream'] + '.' + r['stat']:36s} "
                f"{_fmt(r['a']):>12s} -> {_fmt(r['b']):>12s}  "
                f"({_fmt(100 * r['rel']):>8s}%)")
    lines.append("")
    lines.append(f"top regressions by relative change "
                 f"({len(diff['top_regressions'])} of {diff['n_changed']} changed):")
    for r in diff["top_regressions"]:
        lines.append(
            f"  {r['metric']:52s} {_fmt(r['a']):>12s} -> {_fmt(r['b']):>12s}  "
            f"({_fmt(100 * r['rel']):>8s}%)")
    if not diff["top_regressions"]:
        lines.append("  (no common scalar moved)")
    for side, keys in (("A", diff["only_in_a"]), ("B", diff["only_in_b"])):
        if keys:
            shown = ", ".join(keys[:6]) + (" ..." if len(keys) > 6 else "")
            lines.append(f"only in {side}: {len(keys)} metric(s): {shown}")
    return "\n".join(lines)
