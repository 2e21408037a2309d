"""The port's plan pipeline, artifacts and verifier (``repro_torch.plan``,
``repro_torch.analyze``) against the JAX package's, on the same inputs.

Every comparison is ``==``: the canonical artifact bytes
(``dumps_canonical``) of the same pipeline on the same events under the
same ``HardwareSpec``, the verifier's certificates, and plan caches that
each side writes and the other reads.  A trace captured by the reference's
jaxpr tracer is carried into the port through the artifact format, which
is how a captured trace and its plans cross between the two packages.
The framework-free cases of ``tests/test_plan_artifact.py`` (LRU eviction,
version mismatch, corrupt artifacts, re-verification on load) are held
here on the port's cache.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.analyze as R_analyze
import repro.core.simulator as R_sim
import repro.plan as R_plan
import repro_torch.analyze as P_analyze
import repro_torch.core.simulator as P_sim
import repro_torch.plan as P_plan
from repro.core.trace import RecordingDevice as R_RecordingDevice
from repro.core.trace import trace_step_fn
from repro.runtime.workload import synthetic_train_trace as R_synthetic_train_trace
from repro_torch.core.offload import KNOWN_NAMES
from repro_torch.core.trace import RecordingDevice as P_RecordingDevice
from repro_torch.runtime.workload import synthetic_train_trace as P_synthetic_train_trace
from tests.test_torch_solvers import SCORERS, SPECS, THRESHOLD, drive, to_port

REPO = Path(__file__).resolve().parent.parent
POOLS = ("best_fit", "first_fit", "cnmem", "exact")


def passes(P, limits, scorers=SCORERS):
    """The canonical middle- and back-end, built from package ``P``."""
    out = [P.TimingAssign(), P.PoolPlacement(POOLS)]
    for limit in limits:
        for scorer in scorers:
            out.append(P.SwapSelection(limit=limit, scorer=scorer))
            out.append(P.OffloadLowering(limit=limit, scorer=scorer))
    return out


def solve_both(make_program, hw: str, fracs=(0.9, 0.7, 0.5), size_threshold=THRESHOLD):
    """Run the same pipeline in both packages; return (reference, port)
    programs.  ``make_program(P)`` builds package P's unsolved program."""
    out = []
    for P, spec in ((R_plan, SPECS[hw][0]), (P_plan, SPECS[hw][1])):
        ctx = P.PassContext(hw=spec, size_threshold=size_threshold)
        prog = make_program(P)
        prog = P.Pipeline([P.IterationDetect(), P.TimingAssign()]).run(prog, ctx)
        peak = prog.require_trace().peak_load()
        out.append(P.Pipeline(passes(P, [int(peak * f) for f in fracs])).run(prog, ctx))
    return out


def assert_same_plan(ref, port):
    blob = R_plan.dumps_canonical(ref)
    assert P_plan.dumps_canonical(port) == blob
    want = R_analyze.verify_program(ref)
    got = P_analyze.verify_program(port)
    assert got.ok and want.ok
    assert got.to_dict() == want.to_dict()
    # The port reads its own bytes back byte for byte.
    assert P_plan.dumps_canonical(P_plan.program_from_json(json.loads(blob))) == blob


def device_events(RecordingDevice, seed: int):
    dev = RecordingDevice(min_period=4)
    drive(dev, seed)
    return dev.events


def named_synthetic(synthetic_train_trace):
    """qwen3-4b-shaped layers at a few layers, with the activations labelled
    by the known offload classes so that OffloadLowering has names to pick."""
    tr = synthetic_train_trace(n_layers=6, act_bytes=10_485_760, weight_bytes=201_850_880,
                               flops_per_op=4.13e11, bytes_per_op=201_850_880)
    for i, v in enumerate(v for v in tr.variables if v.size == 10_485_760):
        v.name = KNOWN_NAMES[i % len(KNOWN_NAMES)]
    return tr


# ------------------------------------------------------------- the pipeline
@pytest.mark.parametrize("hw", ["gtx1080ti", "tpu_v5e", "h100_sxm"])
@pytest.mark.parametrize("seed", range(2))
def test_pipeline_on_device_events_byte_equal(hw, seed):
    def make(P):
        RD = R_RecordingDevice if P is R_plan else P_RecordingDevice
        return P.Pipeline([P.TraceCapture(events=device_events(RD, seed))]).run(None, P.PassContext())

    ref, port = solve_both(make, hw, size_threshold=1)
    assert ref.trace is not None and port.raw_events is None
    assert_same_plan(ref, port)


@pytest.mark.parametrize("hw", ["gtx1080ti", "tpu_v5e", "h100_sxm"])
def test_pipeline_on_synthetic_trace_byte_equal(hw):
    def make(P):
        fn = R_synthetic_train_trace if P is R_plan else P_synthetic_train_trace
        return P.MemoryProgram.from_trace(named_synthetic(fn), P.PlanKey("qwen3-4b", "synth", hw))

    ref, port = solve_both(make, hw)
    assert any(p.offload_names for p in port.offload_plans.values())
    assert_same_plan(ref, port)


def grad_step(w, x):
    """tests/test_trace_iteration.py's train step with a backward phase."""
    return jax.grad(lambda w: jnp.sum(jnp.tanh(x @ w) ** 2))(w)


def labelled_step(w, x):
    """tests/test_trace_iteration.py's checkpoint_name step."""
    from jax.ad_checkpoint import checkpoint_name

    def f(w):
        h = checkpoint_name(jnp.tanh(x @ w), "block_in")
        return jnp.sum(h * h)
    return jax.grad(jax.checkpoint(f, policy=None))(w)


@pytest.mark.parametrize("step", [grad_step, labelled_step], ids=["grad", "checkpoint_name"])
def test_captured_trace_carried_across(step):
    """A trace captured by the reference's jaxpr tracer crosses into the port
    as an artifact; the port's passes on it give the reference's bytes."""
    w = jax.ShapeDtypeStruct((32, 32), jnp.float32)
    x = jax.ShapeDtypeStruct((8, 32), jnp.float32)
    trace = trace_step_fn(step, w, x)
    key = R_plan.PlanKey("toy", "train:b8", "h100_sxm")
    captured = json.dumps(R_plan.program_to_json(R_plan.MemoryProgram.from_trace(trace, key)))

    def make(P):
        if P is R_plan:
            return R_plan.MemoryProgram.from_trace(trace, key)
        return P_plan.program_from_json(json.loads(captured))

    ref, port = solve_both(make, "h100_sxm", size_threshold=1)
    assert port.key == P_plan.PlanKey("toy", "train:b8", "h100_sxm")
    assert port.swap_summaries and port.pool_plans["best_fit"].footprint > 0
    assert_same_plan(ref, port)


# ------------------------------------------------------------ cache crossing
def synthetic_program(P, key_sig: str, hw: str = "h100_sxm"):
    fn = R_synthetic_train_trace if P is R_plan else P_synthetic_train_trace
    key = P.PlanKey("qwen3-4b", key_sig, hw)
    return P.MemoryProgram.from_trace(named_synthetic(fn), key)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_plan_cache_read_across(tmp_path, writer):
    ref, port = solve_both(lambda P: synthetic_program(P, "cache"), "h100_sxm", fracs=(0.7,))
    W, R = (R_plan, P_plan) if writer == "reference" else (P_plan, R_plan)
    written = ref if writer == "reference" else port
    W.ArtifactSave().run(written, W.PassContext(hw=SPECS["h100_sxm"][writer == "port"],
                                                cache=W.PlanCache(tmp_path)))
    key = R.PlanKey("qwen3-4b", "cache", "h100_sxm")
    restored = R.PlanCache(tmp_path).load(key)
    assert restored is not None and restored.from_cache
    assert R.dumps_canonical(restored) == W.dumps_canonical(written)
    assert restored.certificate == written.certificate
    # The reader's cache-hit path: TraceCapture restores it, nothing re-solves.
    ctx = R.PassContext(hw=SPECS["h100_sxm"][writer == "reference"], cache=R.PlanCache(tmp_path),
                        key=key)
    again = R.Pipeline([R.TraceCapture()] + passes(R, [next(iter(restored.swap_summaries.values())).limit],
                                                     ("swdoa",))).run(None, ctx)
    assert again.from_cache and R.dumps_canonical(again) == W.dumps_canonical(written)


# ----------------------------------- tests/test_plan_artifact.py, on the port
HW = SPECS["test"][1]


def solved_program(key=None):
    from tests.test_plan_artifact import make_trace as r_make_trace

    tr = to_port(r_make_trace([
        (4 << 20, 0, 3), (2 << 20, 1, 6), (8 << 20, 2, 9),
        (1 << 20, 4, 8), (4 << 20, 5, 10), (2 << 20, 7, 10),
    ]))
    limit = int(tr.peak_load() * 0.8)
    return P_plan.Pipeline([
        P_plan.TimingAssign(), P_plan.PoolPlacement(POOLS),
        P_plan.SwapSelection(limit=limit, scorer="swdoa"), P_plan.OffloadLowering(limit=limit),
    ]).run(P_plan.MemoryProgram.from_trace(tr, key), P_plan.PassContext(hw=HW, size_threshold=THRESHOLD))


def store_n(cache, n):
    return [cache.store(solved_program(P_plan.PlanKey("synthetic", f"unit{i}", HW.name)))
            for i in range(n)]


def test_cache_eviction_is_lru(tmp_path):
    probe = P_plan.PlanCache(tmp_path / "probe")
    size = store_n(probe, 1)[0].stat().st_size
    cache = P_plan.PlanCache(tmp_path / "bound", max_bytes=int(2.5 * size))
    store_n(cache, 4)
    assert len(cache.keys()) == 2
    assert cache.load(P_plan.PlanKey("synthetic", "unit3", HW.name)) is not None
    assert cache.load(P_plan.PlanKey("synthetic", "unit0", HW.name)) is None
    # A hit refreshes recency: LRU, not FIFO.
    lru = P_plan.PlanCache(tmp_path / "lru")
    p0, p1 = store_n(lru, 2)
    os.utime(p0, (1000, 1000))
    os.utime(p1, (2000, 2000))
    assert lru.load(P_plan.PlanKey("synthetic", "unit0", HW.name)) is not None
    lru.max_bytes = int(2.5 * size)
    lru.store(solved_program(P_plan.PlanKey("synthetic", "unit2", HW.name)))
    assert lru.load(P_plan.PlanKey("synthetic", "unit0", HW.name)) is not None
    assert lru.load(P_plan.PlanKey("synthetic", "unit1", HW.name)) is None
    # The artifact just written is never evicted.
    tiny = P_plan.PlanCache(tmp_path / "tiny", max_bytes=size // 2)
    store_n(tiny, 2)
    assert tiny.keys() == [P_plan.PlanKey("synthetic", "unit1", HW.name).cache_name()]


def test_cache_version_mismatch_is_silent_miss(tmp_path):
    cache = P_plan.PlanCache(tmp_path)
    key = P_plan.PlanKey("synthetic", "unit-v", HW.name)
    path = cache.store(solved_program(key))
    blob = json.loads(path.read_text())
    assert blob["version"] == P_plan.PLAN_FORMAT_VERSION == R_plan.PLAN_FORMAT_VERSION == 1
    blob["version"] += 1
    path.write_text(json.dumps(blob))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert cache.load(key) is None
    assert not caught and cache.version_misses == 1
    with pytest.raises(ValueError):
        P_plan.program_from_json(blob)


def test_cache_corrupt_artifact_warns_and_misses(tmp_path):
    cache = P_plan.PlanCache(tmp_path)
    key = P_plan.PlanKey("synthetic", "unit-c", HW.name)
    path = cache.store(solved_program(key))
    for corrupt in ("{not json", "null", "[]"):
        path.write_text(corrupt)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert cache.load(key) is None
        assert caught, corrupt
    assert cache.version_misses == 0


def test_cache_load_reverifies(tmp_path):
    cache = P_plan.PlanCache(tmp_path)
    key = P_plan.PlanKey("synthetic", "cert", HW.name)
    prog = solved_program(key)
    P_plan.ArtifactSave().run(prog, P_plan.PassContext(hw=HW, cache=cache))
    assert json.loads(cache.path_for(key).read_text())["certificate"] == prog.certificate
    assert all(c["violations"] == [] for c in prog.certificate["checks"].values())
    restored = cache.load(key)
    assert restored.certificate == prog.certificate and cache.certificate_misses == 0
    # Tampered bytes (every swap decision dropped, the planned floor kept)
    # fail re-verification and are demoted to a miss.
    path = cache.path_for(key)
    payload = json.loads(path.read_text())
    for s in payload["swap_summaries"].values():
        s["decisions"] = []
    path.write_text(json.dumps(payload, sort_keys=True, separators=(",", ":")))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert cache.load(key) is None
    assert any("failed re-verification" in str(w.message) for w in caught)
    assert cache.certificate_misses == 1


# ---------------------------------------------------------- the H100 spec
def test_h100_spec_has_its_own_name_and_cache_names():
    h100 = P_sim.H100_SXM
    reference_specs = [v for v in vars(R_sim).values() if isinstance(v, R_sim.HardwareSpec)]
    assert {s.name for s in reference_specs} == {"gtx1080ti", "tpu_v5e"}
    assert h100.name == "h100_sxm" and h100.name not in {s.name for s in reference_specs}
    names = {P_plan.PlanKey("qwen3-4b", "train:b4s512", s.name).cache_name()
             for s in reference_specs + [h100]}
    assert len(names) == len(reference_specs) + 1
    assert P_plan.PassContext().hw is h100
    assert (h100.peak_flops, h100.hbm_bw, h100.ici_bw) == (989e12, 3.35e12, 450e9)
    assert 0 < h100.efficiency < 1 and 0 < h100.link_bw < 64e9
    # Defaults kept from the reference.
    assert (h100.op_overhead_s, h100.malloc_cost_s) == (2e-6, 0.0)


def test_trace_capture_of_a_step_fn_names_queue_a5(tmp_path):
    ctx = P_plan.PassContext(cache=P_plan.PlanCache(tmp_path), key=P_plan.PlanKey("a", "b", "c"))
    with pytest.raises(NotImplementedError, match="A5"):
        P_plan.TraceCapture(step_fn=lambda x: x, example_args=(np.zeros(2),)).run(None, ctx)
    with pytest.raises(P_plan.PlanCacheMiss):
        P_plan.TraceCapture().run(None, ctx)


def test_registry_and_surface_match_the_reference():
    assert P_plan.pool_names() == R_plan.pool_names()
    assert P_plan.scorer_names() == R_plan.scorer_names()
    assert P_plan.__all__ == R_plan.__all__
    import repro.core as R_core
    import repro_torch.core as P_core

    assert set(P_core.__all__) == set(R_core.__all__) - {"trace_jaxpr", "trace_step_fn"} | {"H100_SXM"}


# ------------------------------------------------------------ no JAX in the port
def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.core, repro_torch.plan, repro_torch.analyze, repro_torch.runtime\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and (m in ('jax', 'repro') or m.startswith(('jax.', 'repro.'))))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
