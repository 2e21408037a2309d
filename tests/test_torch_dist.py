"""The port's mesh-aware planning (``repro_torch.dist``) against the JAX
package's ``repro.dist`` on the CPU.

``MeshSpec``, the shard divisors, the collectives' cost model,
``_synthesized``, ``shard_existing_trace``, ``solve_sharded`` and
``run_mesh`` are the reference's code: given the same inputs (one sharded
capture of ``tests/test_dist.py``'s step, its trace carried into the
port's objects, and the same ``HardwareSpec`` values) their results are
``==``, byte for byte where they are bytes (``dumps_canonical``, the
simulated report as JSON).  The port's capture walks its own graphs, so it
is held to invariants: a 1x1 capture and its plan are byte-identical to
the single-device path, a batch-sharded input is divided by the mesh,
the per-device peak stays under ``bench_dist.py``'s bound, the functional
collectives are tagged, and a 0-byte input shifts no divisor.
``test_dist.py::test_shard_map_partitioned_jaxpr_capture`` fails in the
reference (ROADMAP queue C) and has no counterpart.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.dist as R
import repro_torch.dist as D
from repro.core.simulator import GTX_1080TI as R_HW, TPU_V5E as R_V5E
from repro.dist import capture as R_capture
from repro.dist.program import group_key as R_group_key
from repro.plan import PlanCache as R_PlanCache, PlanKey as R_PlanKey
from repro.plan import dumps_canonical as R_dumps
from repro.runtime import simulated_report_dict as R_report_dict
from repro.runtime import synthetic_train_trace as R_synthetic
from repro_torch.core.simulator import GTX_1080TI as P_HW, TPU_V5E as P_V5E, assign_times
from repro_torch.core.trace import trace_graph, trace_step_fn, capture_graph, input_names
from repro_torch.dist import capture as P_capture
from repro_torch.dist.program import group_key as P_group_key
from repro_torch.distributed import PartitionSpec as P
from repro_torch.plan import PlanCache as P_PlanCache, PlanKey as P_PlanKey
from repro_torch.plan import dumps_canonical as P_dumps
from repro_torch.plan.passes import (PassContext, Pipeline, PoolPlacement, SwapSelection,
                                     TimingAssign, TraceCapture)
from repro_torch.runtime import simulated_report_dict as P_report_dict
from repro_torch.runtime import synthetic_train_trace as P_synthetic
from tests.test_torch_solvers import to_port

HWS = {"1080ti": (R_HW, P_HW), "v5e": (R_V5E, P_V5E)}


# ------------------------------------------------------------------- steps
def jax_step():
    """tests/test_dist.py's small_step."""
    def step(w, x):
        g = jax.grad(lambda w: ((jax.nn.relu(x @ w)) ** 2).sum())(w)
        return w - 0.01 * g

    return step, (jax.ShapeDtypeStruct((64, 64), jnp.float32),
                  jax.ShapeDtypeStruct((32, 64), jnp.float32))


def torch_step():
    """The same step in the port: w [64, 64], x [32, 64] on meta."""
    def step(w, x):
        w = w.detach().requires_grad_(True)
        loss = (torch.relu(x @ w) ** 2).sum()
        (g,) = torch.autograd.grad(loss, [w])
        return w.detach() - 0.01 * g

    return step, (torch.empty(64, 64, device="meta"), torch.empty(32, 64, device="meta"))


EXTRA = [("all_reduce", 64 * 64 * 4), ("all_gather", 64 * 64 * 2, 0.4)]


def ref_capture(shards: int = 4, extra=EXTRA, hw=R_HW, specs=(JP(None, None), JP("data", None))):
    step, args = jax_step()
    return R.capture_sharded_trace(step, *args, mesh=R.MeshSpec.make(data=shards), hw=hw,
                                   in_specs=specs, arg_names=["w", "x"],
                                   extra_collectives=extra)


def port_capture(ref) -> D.ShardedCapture:
    """The reference's capture as the port's objects (its trace by
    ``to_port``), taken before either side solves (a solve assigns times)."""
    return D.ShardedCapture(
        mesh=D.MeshSpec(ref.mesh.axes),
        groups={g: D.ShardedTrace(to_port(s.trace),
                                  [D.Collective(*dataclasses.astuple(c)) for c in s.collectives])
                for g, s in ref.groups.items()},
        device_group=dict(ref.device_group),
        spec_signature=ref.spec_signature,
    )


def both_captures(**kw):
    ref = ref_capture(**kw)
    return ref, port_capture(ref)


def collectives(cs) -> list[tuple]:
    return [dataclasses.astuple(c) for c in cs]


# ------------------------------------------------------------ mesh + divisors
@pytest.mark.parametrize("text", ["data=4,model=2", "data=1", "pod=2,data=2,model=4",
                                  " data = 3 , ", "model=2"])
def test_mesh_spec_parse_and_signature(text):
    r, p = R.MeshSpec.parse(text), D.MeshSpec.parse(text)
    assert p.axes == r.axes
    assert (p.num_devices, p.signature()) == (r.num_devices, r.signature())
    for names in (None, "data", ("pod", "data"), ("model", "absent"), ()):
        assert p.axis_size(names) == r.axis_size(names)
    assert D.MeshSpec.make(**dict(p.axes)) == p


@pytest.mark.parametrize("text", ["nonsense", "", "data=x", ","])
def test_mesh_spec_parse_errors(text):
    with pytest.raises(ValueError) as r:
        R.MeshSpec.parse(text)
    with pytest.raises(ValueError) as p:
        D.MeshSpec.parse(text)
    assert str(p.value) == str(r.value)


def test_mesh_spec_from_mesh():
    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 4, "model": 2}

    assert D.MeshSpec.from_mesh(Mesh()).axes == R.MeshSpec.from_mesh(Mesh()).axes


DIVISOR_CASES = [((32, 64), ("data", None)), ((32, 64), ("data", "model")),
                 ((30, 64), ("data", "model")), ((32, 64), (None, None)),
                 ((32, 64), (("data", "model"), None)), ((12, 8, 3), (None, ("pod", "data"), "model")),
                 ((0, 8), ("data", None)), ((8,), ("absent",)), ((16, 16), ("model",))]


@pytest.mark.parametrize("shape,spec", DIVISOR_CASES)
def test_shard_divisor_divisibility_guard(shape, spec):
    for text in ("data=4,model=2", "pod=2,data=2,model=4", "data=1"):
        r = R.shard_divisor(shape, JP(*spec), R.MeshSpec.parse(text))
        assert D.shard_divisor(shape, P(*spec), D.MeshSpec.parse(text)) == r


def test_divisors_from_specs_and_param_bytes():
    # Keys in sorted order: jax flattens a dict sorted, the port in order.
    shapes_r = {"b": [jax.ShapeDtypeStruct((30, 8), jnp.bfloat16),
                      jax.ShapeDtypeStruct((16,), jnp.float32)],
                "w": jax.ShapeDtypeStruct((64, 64), jnp.float32)}
    specs_r = {"b": [JP("data", "model"), None], "w": JP("data", None)}
    shapes_p = {"b": [torch.empty(30, 8, dtype=torch.bfloat16, device="meta"),
                      torch.empty(16, device="meta")],
                "w": torch.empty(64, 64, device="meta")}
    specs_p = {"b": [P("data", "model"), None], "w": P("data", None)}
    for text in ("data=4,model=2", "model=2", "data=2"):
        r, p = R.MeshSpec.parse(text), D.MeshSpec.parse(text)
        assert D.divisors_from_specs(shapes_p, specs_p, p) == R.divisors_from_specs(
            shapes_r, specs_r, r)
        assert D.sharded_param_bytes(shapes_p, specs_p, p) == R.sharded_param_bytes(
            shapes_r, specs_r, r)
        assert D.gradient_sync_collective(shapes_p, specs_p, p) == \
            R.gradient_sync_collective(shapes_r, specs_r, r)
    with pytest.raises(ValueError, match="shape leaves"):
        D.divisors_from_specs(shapes_p, {"w": P(None, None)}, D.MeshSpec.make(data=2))


def test_partition_spec_is_plain_data():
    import copy
    import pickle

    spec = P(("pod", "data"), None, "model")
    assert tuple(spec) == tuple(JP(("pod", "data"), None, "model"))
    assert copy.deepcopy(spec) == spec and pickle.loads(pickle.dumps(spec)) == spec
    assert isinstance(copy.copy(spec), P) and P() == ()


# -------------------------------------------------------------- collectives
@pytest.mark.parametrize("hw", sorted(HWS))
def test_collective_seconds_cost_model(hw):
    rh, ph = HWS[hw]
    for kind in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "permute",
                 "broadcast"):
        for nbytes in (0, 1, 1 << 20, 3_000_001):
            for ndev in (0, 1, 2, 4, 8):
                assert D.collective_seconds(kind, nbytes, ndev, ph) == R.collective_seconds(
                    kind, nbytes, ndev, rh)
    assert D.collective_seconds("all_reduce", 1 << 20, 4, ph) > D.collective_seconds(
        "all_gather", 1 << 20, 4, ph) > 0.0


def test_synthesized_collectives_positions():
    ref = ref_capture(extra=[])
    trace_r = ref.groups["spmd"].trace
    extra = [("all_reduce", 1 << 20), ("all_gather", 1 << 20, 0.5), ("all_reduce", 1 << 20, None),
             ("reduce_scatter", 4096, 0.0), ("all_to_all", 4096, 7), ("permute", 4096, -3),
             ("all_reduce", 4096, 10**9), ("all_reduce", 1 << 20, None, 2), ("all_reduce", 0)]
    for text in ("data=4", "data=4,model=2", "data=1"):
        got = P_capture._synthesized(extra, to_port(trace_r), D.MeshSpec.parse(text), P_HW)
        want = R_capture._synthesized(extra, trace_r, R.MeshSpec.parse(text), R_HW)
        assert collectives(got) == collectives(want)
    assert [c.kind for c in got] == ["all_reduce"]  # one device: only the one scoped to 2
    tail = trace_r.num_indices - 1
    got = P_capture._synthesized(extra[:2], to_port(trace_r), D.MeshSpec.make(data=4), P_HW)
    assert got[0].index == tail and 0 < got[1].index < tail


def test_shard_existing_trace_rule_route():
    def rule(name, size):
        return 4 if name.startswith("act") else 3 if size % 3 == 0 else 1

    extra = [("all_reduce", 1 << 20), ("all_gather", 1 << 16, 0.3)]
    got = D.shard_existing_trace(P_synthetic(6), D.MeshSpec.make(data=4), P_HW, rule, extra)
    want = R.shard_existing_trace(R_synthetic(6), R.MeshSpec.make(data=4), R_HW, rule, extra)
    g, w = got.groups["spmd"], want.groups["spmd"]
    assert [dataclasses.astuple(v) for v in g.trace.variables] == \
        [dataclasses.astuple(v) for v in w.trace.variables]
    assert (g.trace.num_indices, g.trace.op_costs, g.trace.op_extra_s) == \
        (w.trace.num_indices, w.trace.op_costs, w.trace.op_extra_s)
    assert collectives(g.collectives) == collectives(w.collectives) and g.collectives
    assert (got.spec_signature, got.plan_topology(), got.device_group) == \
        (want.spec_signature, want.plan_topology(), want.device_group)


# ------------------------------------------------------- plans and caching
@pytest.mark.parametrize("limit", [None, 0.7, "frac"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_solve_sharded_programs_equal(shards, limit, tmp_path):
    """The same capture solved on both sides: equal programs, byte for
    byte, and equal cache files; a second solve restores them."""
    ref, port = both_captures(shards=shards)
    peak = ref.groups["spmd"].trace.peak_load()
    kw = dict(size_threshold=1)
    if limit == "frac":
        kw["limit_frac"] = 0.6
    elif limit is not None:
        kw["limit"] = int(peak * limit)
    out = {}
    for side, mod, key_cls, cache_cls, dumps, hw in (
            ("ref", R, R_PlanKey, R_PlanCache, R_dumps, R_HW),
            ("port", D, P_PlanKey, P_PlanCache, P_dumps, P_HW)):
        cap = ref if side == "ref" else port
        cache = cache_cls(tmp_path / side)
        key = key_cls("toy", "train:t", hw.name)
        first = mod.solve_sharded(cap, hw, base_key=key, cache=cache, **kw)
        again = mod.solve_sharded(cap, hw, base_key=key, cache=cache, **kw)
        assert not first.cache_hits["spmd"] and again.cache_hits["spmd"]
        assert dumps(again.programs["spmd"]) == dumps(first.programs["spmd"])
        files = {p.name: p.read_bytes() for p in sorted((tmp_path / side).iterdir())}
        limit, decisions = mod.solved_decisions(first, "spmd")
        out[side] = (dumps(first.programs["spmd"]), first.swap_keys, first.per_device_peak(),
                     limit, [dataclasses.astuple(d) for d in decisions], sorted(files))
    assert out["port"] == out["ref"]


def test_group_key_topologies():
    caps = [both_captures(shards=n) for n in (1, 2, 4)]
    caps.append(both_captures(shards=4, specs=(JP("data", None), JP("data", None))))
    names = set()
    for ref, port in caps:
        for group in ("spmd", "g1"):
            r = R_group_key(R_PlanKey("toy", "train:t", "h"), ref, group)
            p = P_group_key(P_PlanKey("toy", "train:t", "h"), port, group)
            assert (p.topology, p.cache_name()) == (r.topology, r.cache_name())
            names.add(p.cache_name())
        assert P_group_key(None, port, "spmd") is None
    assert len(names) == 7  # 1x1 keys the same under every group name
    assert caps[0][1].plan_topology() == ""


# ------------------------------------------------------------ mesh execution
def solved_pair(shards=4, limit_frac=0.6):
    ref, port = both_captures(shards=shards)
    return (R.solve_sharded(ref, R_HW, limit_frac=limit_frac, size_threshold=1),
            D.solve_sharded(port, P_HW, limit_frac=limit_frac, size_threshold=1))


def mesh_run(side, solved, **kw):
    mod, hw, report_dict = (R, R_HW, R_report_dict) if side == "ref" else (D, P_HW,
                                                                             P_report_dict)
    res = mod.run_mesh(solved, hw, **kw)
    return res, json.dumps(report_dict(res.report), sort_keys=True)


RUNS = {
    "free": dict(contended=False, iterations=2),
    "shared": dict(contended=True, link_lanes=2, iterations=2),
    "blind": dict(contended=True, contention_aware=False, link_lanes=2, iterations=3),
    "aware": dict(contended=True, contention_aware=True, link_lanes=2, iterations=3),
    "directional": dict(contended=True, lane_split="directional", link_lanes=3, iterations=2),
    "narrow": dict(contended=True, link_bw=1e9, link_lanes=1, channels=1, iterations=2,
                   prefetch="eager"),
    "unlogged": dict(contended=True, record_events=False, iterations=2),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_mesh_equal(run):
    solved = dict(zip(("ref", "port"), solved_pair()))
    peak = solved["ref"].capture.groups["spmd"].trace.peak_load()
    got = {}
    for side in ("ref", "port"):
        res, report = mesh_run(side, solved[side], budget_per_device=peak, **RUNS[run])
        got[side] = (report, res.schedules, res.lane_split, res.lane_info, res.makespan_s,
                     res.max_overhead(), res.mean_overhead())
    assert got["port"] == got["ref"]


def test_run_mesh_per_device_pools_fanout_and_blackout():
    """tests/test_dist.py's execution claims, on the port's runs: per-device
    pools, SPMD fan-out, the blackout registered once per collective,
    contention moving schedules, aware no worse than blind."""
    _, solved = solved_pair()
    group = solved.capture.groups["spmd"]
    peak = group.trace.peak_load()
    res, _ = mesh_run("port", solved, budget_per_device=peak, iterations=2)
    rep = res.report
    assert len(rep.tenants) == 4 and all(t.status == "completed" for t in rep.tenants)
    assert len(set(rep.device_peaks.values())) == 1
    assert rep.aggregate_peak == sum(rep.device_peaks.values()) and rep.overflow_events == 0
    assert rep.link["blackout_s"] == pytest.approx(2 * sum(c.seconds for c in group.collectives))
    free, _ = mesh_run("port", solved, budget_per_device=peak, contended=False, iterations=2)
    assert D.schedules_differ(free, res) and res.makespan_s >= free.makespan_s - 1e-12
    aware, _ = mesh_run("port", solved, budget_per_device=peak, link_lanes=2, iterations=3)
    blind, _ = mesh_run("port", solved, budget_per_device=peak, link_lanes=2, iterations=3,
                        contention_aware=False)
    assert aware.mean_overhead() <= blind.mean_overhead() + 1e-9
    with pytest.raises(ValueError, match="lane_split"):
        D.run_mesh(solved, P_HW, lane_split="diagonal")


# ------------------------------------------------------ the port's capture
def test_1x1_capture_events_byte_identical_to_single_device():
    step, args = torch_step()
    ref = trace_step_fn(step, *args, arg_names=["w", "x"], device="cpu")
    cap = D.capture_sharded_trace(step, *args, mesh=D.MeshSpec.make(data=1), hw=P_HW,
                                  in_specs=(P(None, None), P("data", None)),
                                  arg_names=["w", "x"], device="cpu")
    got = cap.groups["spmd"].trace
    assert [dataclasses.astuple(v) for v in got.variables] == \
        [dataclasses.astuple(v) for v in ref.variables]
    assert (got.num_indices, got.op_costs, got.op_extra_s) == (ref.num_indices, ref.op_costs,
                                                               None)
    assert not cap.groups["spmd"].collectives and cap.plan_topology() == ""


def test_1x1_solved_plan_byte_identical_to_pipeline():
    step, args = torch_step()
    key = P_PlanKey("toy", "train:t", P_HW.name)
    cap = D.capture_sharded_trace(step, *args, mesh=D.MeshSpec.make(data=1), hw=P_HW,
                                  arg_names=["w", "x"], device="cpu")
    limit = int(cap.groups["spmd"].trace.peak_load() * 0.7)
    solved = D.solve_sharded(cap, P_HW, base_key=key, limit=limit, size_threshold=1)
    single = Pipeline([
        TraceCapture(step_fn=step, example_args=args, arg_names=["w", "x"]),
        TimingAssign(), PoolPlacement(), SwapSelection(limit=limit),
    ]).run(None, PassContext(hw=P_HW, key=key, size_threshold=1))
    assert P_dumps(solved.programs["spmd"]) == P_dumps(single)
    assert solved.programs["spmd"].key == key


def test_1x1_model_step_byte_identical():
    """The smoke qwen3-4b loss step through ``shardplan.capture_for_mesh`` on
    a 1x1 mesh: the events of ``trace_graph`` and the same plan."""
    from repro_torch.launch.shardplan import build_probe, capture_for_mesh

    cfg, _, step, args = build_probe("qwen3-4b", True, 2, 32, "cpu")
    gm = capture_graph(step, *args, device="cpu")
    cap = capture_for_mesh(cfg, step, args, D.MeshSpec.make(data=1), P_HW, graph=gm)
    ref = trace_graph(gm, arg_names=input_names(args, ["params", "batch"]))
    got = cap.groups["spmd"].trace
    assert [dataclasses.astuple(v) for v in got.variables] == \
        [dataclasses.astuple(v) for v in ref.variables]
    assert got.op_costs == ref.op_costs and cap.plan_topology() == ""


def replicated_bytes_peak(single, sharded) -> int:
    """bench_dist.py's tolerance: the peak load of the variables sharding
    does not divide."""
    from repro_torch.core.events import IterationTrace

    d_size = {v.var: v.size for v in sharded.variables}
    kept = [v for v in single.variables if d_size.get(v.var) == v.size]
    return IterationTrace(kept, single.num_indices).peak_load()


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_capture_divides_batch_sharded_sizes(shards):
    step, args = torch_step()
    cap = D.capture_sharded_trace(step, *args, mesh=D.MeshSpec.make(data=shards), hw=P_HW,
                                  in_specs=(P(None, None), P("data", None)),
                                  arg_names=["w", "x"], device="cpu")
    by_name = {}
    for v in cap.groups["spmd"].trace.variables:
        by_name.setdefault(v.name, v)
    assert by_name["x"].size == 32 * 64 * 4 // shards
    assert by_name["w"].size == 64 * 64 * 4
    ref = trace_step_fn(step, *args, arg_names=["w", "x"], device="cpu")
    assert cap.groups["spmd"].trace.peak_load() < ref.peak_load()
    assert cap.plan_topology().startswith(f"data{shards}-")


PEAK_SLACK = 0.01  # bench_dist.py's


@pytest.mark.parametrize("arch,mesh", [("qwen3-4b", "data=2"), ("qwen3-4b", "data=4"),
                                       ("deepseek-v2-lite-16b", "data=4"),
                                       ("mamba2-370m", "data=2,model=2")])
def test_per_device_peak_within_shard_bound(arch, mesh):
    """bench_dist.py's claim on the port's capture of a smoke model's loss:
    the per-device peak is at most the unsharded peak / N plus the bytes
    sharding leaves whole (1% slack), N the data-parallel degree."""
    from repro_torch.launch.shardplan import build_probe, capture_for_mesh

    cfg, _, step, args = build_probe(arch, True, 4, 32, "cpu")
    gm = capture_graph(step, *args, device="cpu")
    m = D.MeshSpec.parse(mesh)
    single = capture_for_mesh(cfg, step, args, D.MeshSpec.make(data=1), P_HW, graph=gm)
    sharded = capture_for_mesh(cfg, step, args, m, P_HW, graph=gm)
    st, dt = single.groups["spmd"].trace, sharded.groups["spmd"].trace
    n = m.axis_size(("pod", "data"))
    bound = st.peak_load() / n + replicated_bytes_peak(st, dt)
    assert dt.peak_load() <= bound * (1 + PEAK_SLACK)
    assert dt.peak_load() < st.peak_load()
    (sync,) = sharded.groups["spmd"].collectives  # the gradient all-reduce, at the end
    assert (sync.kind, sync.index) == ("all_reduce", dt.num_indices - 1)


def test_spec_count_must_match_graph_inputs():
    step, args = torch_step()
    with pytest.raises(ValueError, match="spec leaves"):
        D.capture_sharded_trace(step, *args, mesh=D.MeshSpec.make(data=2), hw=P_HW,
                                in_specs=(P(None, None), P("data", None), P(None)),
                                device="cpu")


def test_zero_byte_input_does_not_shift_divisors():
    """Divisors are keyed by placeholder index: a 0-byte input (no variable,
    no event) between two others leaves the next input its own divisor."""
    def step(w, z, x):
        return (x @ w).sum() + z.sum()

    args = (torch.empty(64, 64, device="meta"), torch.empty(0, 8, device="meta"),
            torch.empty(32, 64, device="meta"))
    cap = D.capture_sharded_trace(step, *args, mesh=D.MeshSpec.make(data=4), hw=P_HW,
                                  in_specs=(P(None, None), P(None, None), P("data", None)),
                                  arg_names=["w", "z", "x"], device="cpu")
    by_name = {v.name: v for v in cap.groups["spmd"].trace.variables}
    assert "z" not in by_name
    assert (by_name["w"].size, by_name["x"].size) == (64 * 64 * 4, 32 * 64 * 4 // 4)


def test_labels_keep_their_base_divisor():
    """A label (``ops.label``, the reference's checkpoint_name) starts a
    variable over its base's storage, already sized per device: it is not
    divided again, and what it feeds keeps the divisor."""
    from repro_torch.kernels import ops

    def step(w, x):
        h = ops.label(torch.relu(x @ w), "block_in")
        return (h @ w).sum()

    args = (torch.empty(64, 64, device="meta"), torch.empty(32, 64, device="meta"))
    cap = D.capture_sharded_trace(step, *args, mesh=D.MeshSpec.make(data=4), hw=P_HW,
                                  in_specs=(P(None, None), P("data", None)),
                                  arg_names=["w", "x"], device="cpu")
    sizes = {v.name: v.size for v in cap.groups["spmd"].trace.variables}
    assert sizes["block_in"] == sizes["relu"] == 32 * 64 * 4 // 4
    assert sizes["mm"] == 32 * 64 * 4 // 4


@pytest.fixture
def fake_world():
    """A process group of 4 fake ranks (no communication), for tracing the
    functional collectives."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def test_functional_collectives_tagged(fake_world):
    import torch.distributed._functional_collectives as funcol

    pair = fake_world.new_group([0, 1])

    def step(x):
        y = funcol.all_reduce((x * 2.0).sum(dim=1), "sum", fake_world.group.WORLD)
        z = funcol.all_gather_tensor(x, 0, fake_world.group.WORLD)
        s = funcol.reduce_scatter_tensor(z, "sum", 0, fake_world.group.WORLD)
        p = funcol.all_reduce(x, "sum", pair)
        return y.sum() + s.sum() + p.sum()

    x = torch.empty(32, 64, device="meta")
    mesh = D.MeshSpec.make(data=4)
    cap = D.capture_sharded_trace(step, x, mesh=mesh, hw=P_HW, in_specs=(P("data", None),),
                                  arg_names=["x"], device="cpu")
    group = cap.groups["spmd"]
    shard = 32 * 64 * 4 // 4
    got = [(c.kind, c.nbytes) for c in group.collectives]
    assert got == [("all_reduce", 32 * 4 // 4), ("all_gather", shard),
                   ("reduce_scatter", 4 * shard), ("all_reduce", shard)]
    ndevs = [4, 4, 4, 2]
    for c, n in zip(group.collectives, ndevs):
        assert c.seconds == D.collective_seconds(c.kind, c.nbytes, n, P_HW) > 0
        assert group.trace.op_extra_s[c.index] == c.seconds
    names = [v.name for v in group.trace.variables]
    assert "wait_tensor" not in names  # the collective's own output, completed
    assign_times(group.trace, P_HW)
    with_extra = group.trace.op_times[-1]
    group.trace.op_extra_s, group.trace.op_times = None, None
    assign_times(group.trace, P_HW)
    assert with_extra == pytest.approx(group.trace.op_times[-1]
                                       + sum(c.seconds for c in group.collectives))

    # On one device no collective fires: the graph's own stream.
    gm = capture_graph(step, x, device="cpu")
    one = P_capture.shard_graph(gm, (x,), mesh=D.MeshSpec.make(data=1), hw=P_HW,
                                arg_names=["x"])
    ref = trace_graph(gm, arg_names=["x"])
    assert [dataclasses.astuple(v) for v in one.groups["spmd"].trace.variables] == \
        [dataclasses.astuple(v) for v in ref.variables]
    assert not one.groups["spmd"].collectives


def test_blackout_exclusion_flags_transfers_acquired_first(monkeypatch):
    """ROADMAP queue C's question about the contended mesh run of
    ``tests/test_torch_obs.py`` (the reference's, bit for bit): each swap-out
    that ``blackout_exclusion`` flags was acquired *before* the owner
    registered the collective's blackout, so the engine honoured every
    blackout it knew of.  The checker reads ``ready < blackout start`` as
    "registered first", but ``ready`` is the tenant's clock after its op
    (and its own collective), not the clock its step was popped at."""
    import repro_torch.analyze.schedule_check as S
    import repro_torch.runtime.engine as E
    from tests.test_torch_obs import _run

    order, blackouts, outs = [0], [], []
    add, acquire = E.HostLink.add_blackout, E.MemoryRuntime.acquire_transfer

    def logged_add(self, start, end, prune_before=None):
        order[0] += 1
        blackouts.append((start, end, order[0]))
        return add(self, start, end, prune_before)

    def logged_acquire(self, run, direction, ready_t, size, var=-1):
        order[0] += 1
        start, end, ch = acquire(self, run, direction, ready_t, size, var)
        if direction == "out":
            outs.append((run.tenant.name, var, ready_t, start, end, order[0]))
        return start, end, ch

    monkeypatch.setattr(E.HostLink, "add_blackout", logged_add)
    monkeypatch.setattr(E.MemoryRuntime, "acquire_transfer", logged_acquire)
    report, rec = _run("port", "mesh", "plain")
    check = S.verify_recorder(rec, report).to_dict()["checks"]["blackout_exclusion"]
    flagged = [(t, v, r, s, e, at) for t, v, r, s, e, at in outs
               for bs, be, reg in blackouts
               if bs < e and s < be and bs < r]
    assert not check["ok"] and len(check["violations"]) == len(flagged) == 2
    for (tenant, var, ready, start, end, at), v in zip(flagged, check["violations"]):
        assert f"out:v{var} ({tenant})" in v["message"]
        (reg,) = [reg for bs, be, reg in blackouts if bs < end and start < be]
        assert at < reg  # acquired before the blackout existed
