"""Launcher glue: one call implements ``--verify`` for every launch CLI.

Counterpart of ``repro/analyze/driver.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_obs.py``
holds the two equal.

``verify_launch(args, programs=..., recorder=..., report=...)`` is a no-op
unless the parsed args carry ``verify=True`` (installed uniformly by
``repro.obs.add_obs_args``).  When active it sweeps every solved
``MemoryProgram`` with the static plan verifier and the attached
``ObsRecorder`` with the event-log race detector, prints one summary per
certificate, and raises ``SystemExit`` if any invariant failed — so a
``--verify`` run is green only when the whole run is proved, not just
simulated.
"""

from __future__ import annotations

from .certificate import Certificate
from .plan_check import verify_program
from .schedule_check import verify_recorder


def _emit(label: str, cert: Certificate) -> None:
    n = len(cert.checks)
    if cert.ok:
        print(f"[verify] {label}: ok ({n} invariants)")
        return
    print(f"[verify] {label}: FAIL ({', '.join(cert.failed())})")
    for line in cert.summary_lines():
        print(f"[verify]   {line}")


def verify_launch(args, programs=None, recorder=None, report=None) -> None:
    """Verify one launcher run; raise ``SystemExit`` on the first failure.

    ``programs`` is a ``{name: MemoryProgram}`` mapping (solved or
    cache-restored), ``recorder`` the run's ``ObsRecorder`` (or None) and
    ``report`` its ``RuntimeReport``.
    """
    if not getattr(args, "verify", False):
        return
    ok = True
    for name, program in sorted((programs or {}).items()):
        cert = verify_program(program)
        _emit(f"plan {name}", cert)
        ok = ok and cert.ok
    if recorder is not None:
        cert = verify_recorder(recorder, report)
        _emit("schedule", cert)
        ok = ok and cert.ok
    if not ok:
        raise SystemExit("[verify] FAILED: invariant violations above")
