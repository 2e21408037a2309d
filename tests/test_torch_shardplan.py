"""The port's spec rules (``repro_torch.launch.steps``) and its mesh-planning
launchers (``launch/shardplan.py``, ``train --dist-plan``) on the CPU.

Every leaf's ``param_specs``, ``batch_specs`` and ``cache_specs_tree`` is
held to the reference's spec for its counterpart leaf, on every
configuration's full shapes (meta tensors against ``jax.eval_shape``) and
three meshes: the reference's leaves of a repeated segment carry a
leading layer dim, which the port's unstacked layers lack, and its
attention K/V caches are [B, S, KV, hd] where the port's are head-major
[B, KV, S, hd], so those specs are compared with dims 1 and 2 swapped.
The launchers run end to end at smoke size on fake CPU tensors.
"""

from __future__ import annotations

import contextlib
import io
import json
from functools import lru_cache

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.launch.steps as R_steps
import repro_torch.launch.steps as P_steps
from repro.configs import get_config as R_config
from repro.dist import MeshSpec as R_MeshSpec, gradient_sync_collective as R_sync
from repro.dist import sharded_param_bytes as R_param_bytes
from repro.launch.shardplan import SpecMesh as R_SpecMesh
from repro.models import build_model as R_build
from repro_torch.configs import get_config as P_config, list_archs
from repro_torch.dist import MeshSpec as P_MeshSpec, gradient_sync_collective as P_sync
from repro_torch.dist import sharded_param_bytes as P_param_bytes
from repro_torch.distributed import PartitionSpec
from repro_torch.launch import shardplan, train
from repro_torch.launch.shardplan import SpecMesh as P_SpecMesh
from repro_torch.models import build_model as P_build

MESHES = ("data=4", "data=2,model=2", "pod=2,data=2,model=4")
B, S = 4, 512


def port_flat(tree, keys=()) -> dict:
    """{path: entries} of a port spec tree (a spec is a tuple: stop there)."""
    if isinstance(tree, PartitionSpec):
        return {keys: tuple(tree)}
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(port_flat(v, keys + (str(k),)))
    return out


def ref_flat(tree, keys=()) -> dict:
    """{path: entries} of a reference spec tree, one path entry a level."""
    if isinstance(tree, JP):
        return {keys: tuple(tree)}
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(ref_flat(v, keys + (str(k),)))
    return out


def unstacked(segs, program) -> dict:
    """A reference per-segment spec tree as the port's per-layer paths
    (``models/convert.py``'s ``unstack_program``): a repeated segment's
    leaves lose their leading layer dim."""
    out, layer = {}, 0
    for (unit, reps), seg in zip(program, segs):
        for _ in range(reps):
            for i in range(len(unit)):
                for path, spec in ref_flat(seg[f"l{i}"]).items():
                    out[(str(layer),) + path] = spec[1:] if reps > 1 else spec
                layer += 1
    return out


def ref_params_flat(cfg, tree) -> dict:
    out = {}
    for name, sub in tree.items():
        if name in ("blocks", "decoder"):
            sub = unstacked(sub, cfg.program)
        elif name == "encoder":
            sub = unstacked(sub, cfg.enc_program)
        else:
            sub = ref_flat(sub)
        out.update({(name,) + k: v for k, v in sub.items()})
    return out


def head_major(path, spec):
    """The reference's [B, S, KV, hd] K/V spec as the port's [B, KV, S, hd]."""
    if path[-1] in ("k", "v") or path[-2] == "enc_kv":
        return (spec[0], spec[2], spec[1], spec[3])
    return spec


def ref_cache_specs(cfg, cache, mesh) -> dict:
    """The reference's cache rule on its per-layer leaves, the repeat dim
    dropped first (its fallback tests ``spec[2]``, which on a stacked leaf
    is the sequence dim, ROADMAP queue C), as the port's paths."""
    layers = []
    for (unit, reps), seg in zip(cfg.program, cache):
        for _ in range(reps):
            for i in range(len(unit)):
                layers.append(jax.tree.map(
                    lambda a: jax.ShapeDtypeStruct(a.shape[1:] if reps > 1 else a.shape, a.dtype),
                    seg[f"l{i}"]))
    out = {}
    for (layer, kind, *rest), spec in ref_flat(R_steps.cache_specs_tree(cfg, layers,
                                                                        mesh)).items():
        spec = head_major((kind, *rest), spec)
        if kind == "enc_kv":  # the reference's (k, v) pair, the port's {"k", "v"}
            rest = ["kv"[int(rest[0])]]
        out[(layer, kind, *rest)] = spec
    return out


@lru_cache(maxsize=None)
def shapes(arch: str):
    """(reference params, port params, reference cache, port cache, port
    model) shapes of ``arch``'s full config."""
    rm, pm = R_build(R_config(arch)), P_build(P_config(arch), "meta")
    return (rm.init_shapes(), pm.init_shapes(torch.float32), jax.eval_shape(lambda: rm.init_cache(B, S)),
            pm.init_cache(B, S), pm)


def meshes(text):
    return R_SpecMesh(R_MeshSpec.parse(text)), P_SpecMesh(P_MeshSpec.parse(text))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference(arch, mesh):
    rp, pp, _, _, _ = shapes(arch)
    rmesh, pmesh = meshes(mesh)
    cfg_r, cfg_p = R_config(arch), P_config(arch)
    want = ref_params_flat(cfg_r, R_steps.param_specs(cfg_r, rp, rmesh))
    got = port_flat(P_steps.param_specs(cfg_p, pp, pmesh))
    assert got == want
    if arch in P_steps.FSDP_ARCHS:
        assert any("data" in str(s) for s in got.values())
    # the gradient all-reduce prices the same bytes over the same devices
    assert P_sync(pp, P_steps.param_specs(cfg_p, pp, pmesh), P_MeshSpec.parse(mesh)) == \
        R_sync(rp, R_steps.param_specs(cfg_r, rp, rmesh), R_MeshSpec.parse(mesh))
    assert P_param_bytes(pp, P_steps.param_specs(cfg_p, pp, pmesh), P_MeshSpec.parse(mesh)) \
        == R_param_bytes(rp, R_steps.param_specs(cfg_r, rp, rmesh), R_MeshSpec.parse(mesh))


@pytest.mark.parametrize("fsdp", [True, False])
def test_fsdp_override_matches_reference(fsdp):
    arch = "deepseek-v2-lite-16b"
    rp, pp, _, _, _ = shapes(arch)
    rmesh, pmesh = meshes("data=2,model=2")
    want = ref_params_flat(R_config(arch), R_steps.param_specs(R_config(arch), rp, rmesh,
                                                               fsdp=fsdp))
    assert port_flat(P_steps.param_specs(P_config(arch), pp, pmesh, fsdp=fsdp)) == want


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_match_reference(arch, mesh):
    _, _, rc, pc, _ = shapes(arch)
    rmesh, pmesh = meshes(mesh)
    want = ref_cache_specs(R_config(arch), rc, rmesh)
    got = port_flat(P_steps.cache_specs_tree(P_config(arch), pc, pmesh))
    assert got == want


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2-vl-7b", "whisper-large-v3"])
def test_batch_specs_match_reference(arch, mesh):
    """The training batch of each kind of frontend: tokens and labels, the
    vision stub's patches and M-RoPE positions, the encoder's frames."""
    _, _, _, _, model = shapes(arch)
    _, (_, probe) = shardplan.probe_from_model(model, B, S)
    ref = {k: jax.ShapeDtypeStruct(tuple(v.shape), jax.numpy.float32) for k, v in probe.items()}
    rmesh, pmesh = meshes(mesh)
    want = ref_flat(R_steps.batch_specs(R_config(arch), ref, rmesh))
    assert port_flat(P_steps.batch_specs(P_config(arch), probe, pmesh)) == want


def test_spec_mesh_reads_mesh_spec():
    m = P_SpecMesh(P_MeshSpec.parse("pod=2,data=2,model=4"))
    r = R_SpecMesh(R_MeshSpec.parse("pod=2,data=2,model=4"))
    assert (m.axis_names, m.shape) == (r.axis_names, r.shape) == (
        ("pod", "data", "model"), {"pod": 2, "data": 2, "model": 4})


# --------------------------------------------------------------- launchers
def run_main(main, argv) -> tuple[object, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = main(argv)
    return ret, out.getvalue()


def test_shardplan_smoke_end_to_end(tmp_path):
    argv = ["--device", "cpu", "--smoke", "--mesh", "data=4", "--plan-cache",
            str(tmp_path / "plans"), "--json", str(tmp_path / "out.json")]
    ret, text = run_main(shardplan.main, argv)
    assert ret == 0 and "[dist] mesh data4: per-device peak" in text
    assert "(cache)" not in text
    payload = json.loads((tmp_path / "out.json").read_text())
    assert payload["mesh"] == {"data": 4} and payload["topology"].startswith("data4-")
    assert payload["per_device_peak"] < payload["single_device_peak"]
    (sync,) = payload["collectives"]
    assert sync["kind"] == "all_reduce"
    ret, again = run_main(shardplan.main, argv)
    assert ret == 0 and "(cache)" in again


def test_shardplan_mesh_and_lanes(tmp_path):
    ret, text = run_main(shardplan.main, [
        "--device", "cpu", "--smoke", "--mesh", "data=2,model=2", "--batch", "4", "--seq", "64",
        "--budget-frac", "1.0", "--lane-split", "directional", "--verify",
        "--trace-out", str(tmp_path / "mesh.trace.json")])
    assert ret == 0 and "[dist] mesh data2xmodel2" in text and "[tune] directional" in text
    assert "[verify] plan spmd: ok" in text
    assert json.loads((tmp_path / "mesh.trace.json").read_text())["traceEvents"]


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        shardplan.main(["--smoke", "--mesh", "data=4"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1", "--dist-plan", "data=4"])


def test_train_dist_plan_smoke(tmp_path):
    argv = ["--device", "cpu", "--smoke", "--steps", "2", "--batch", "2", "--seq", "32",
            "--dist-plan", "data=4", "--verify", "--plan-cache", str(tmp_path / "plans"),
            "--trace-out", str(tmp_path / "t.json")]
    losses, text = run_main(train.main, argv)
    lines = [ln for ln in text.splitlines() if ln.startswith("[dist-plan]")]
    assert lines[0].startswith("[dist-plan] mesh data4 group spmd: per-device peak")
    assert "[dist-plan] mesh run: makespan" in lines[1]
    assert "[verify] plan spmd: ok" in text and "[verify] schedule: ok" in text
    assert len(losses) == 2 and "done: first-loss" in text
    # The sharded plan and the single-device one never share a cache entry.
    _, again = run_main(train.main, argv[:-2] + ["--plan"])
    assert "(restored from cache)" in again.split("[plan]")[0]
    assert "[plan] vars=" in again and len(list((tmp_path / "plans").iterdir())) == 2
