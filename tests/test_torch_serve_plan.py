"""The port's serving steps as the planner sees them: decode with a 0-d
device tensor for its position, the prefill and serve step builders, and
``serve --plan/--plan-cache/--colocate`` against the JAX package's
``plan_serve_steps``, on the CPU.

A tensor position decodes bit for bit as an int did, and the traced
decode step is the same graph whatever the position's value: nothing in
it reads the position back to the host.  The port's serve traces keep the
reference's parameter bytes exactly; peak loads and SmartPool's
footprint agree within stated bands (the two frameworks do not emit the
same ops).
"""

import argparse
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.trace as P_trace
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.smartpool import solve as R_solve
from repro.launch import serve as R_serve
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.core.smartpool import solve as P_solve
from repro_torch.launch import serve
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import init_program_cache
from repro_torch.tree import tree_leaves

ARCHS = ("qwen3-4b", "mamba2-370m")
B, P, GEN = 2, 16, 4  # the serve launcher's smoke shapes in the reference's usage


def _model(arch, dtype="float32", seed=0):
    cfg = get_smoke_config(arch).reduced(dtype=dtype)
    model = build_model(cfg, "cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(seed))


def _prompt(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P)))


def _decode(model, params, tokens, as_tensor):
    """Prefill, then GEN - 1 greedy steps with the position an int or a
    slice of one ``arange`` of dtype ``as_tensor`` -> (every step's logits,
    the final cache)."""
    logits, cache = model.prefill(params, {"tokens": tokens}, max_seq=P + GEN)
    out = [logits]
    positions = torch.arange(P, P + GEN, dtype=as_tensor or torch.long)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    for i in range(GEN - 1):
        pos = positions[i] if as_tensor else P + i
        logits, cache = model.decode_step(params, cache, tok, pos)
        out.append(logits)
        tok = logits[:, -1].argmax(-1, keepdim=True)
    return out, cache


# ------------------------------------------------------------- (a) decode
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,pos_dtype", [("float32", torch.long), ("bfloat16", torch.long),
                                             ("float32", torch.int32)])
def test_tensor_position_decodes_bit_equal_to_an_int(arch, dtype, pos_dtype):
    """int64 positions, as serve passes them, and int32, as the reference
    traces them."""
    cfg, model, params = _model(arch, dtype)
    tokens = _prompt(cfg)
    got, got_cache = _decode(model, params, tokens, as_tensor=pos_dtype)
    want, want_cache = _decode(model, params, tokens, as_tensor=None)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got_cache), tree_leaves(want_cache)))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_tensor_position_decode_matches_jax(dtype, tol):
    """Prefill and greedy decode with a tensor position against the JAX
    model's jitted ``decode_step`` with an int32 scalar, at
    tests/test_torch_serve.py's tolerances."""
    jcfg = jax_smoke_config("qwen3-4b").reduced(dtype=dtype)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config("qwen3-4b").reduced(dtype=dtype)
    model = build_model(cfg, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    tokens = _prompt(cfg)
    got, _ = _decode(model, params, tokens, as_tensor=torch.long)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens.numpy(), jnp.int32)},
                                     max_seq=P + GEN)
    jdecode = jax.jit(jmodel.decode_step)
    for i in range(GEN):
        if i:
            jlogits, jcache = jdecode(jparams, jcache, jtok, jnp.int32(P + i - 1))
        want = np.asarray(jlogits[:, -1:], np.float32)
        have = got[i][:, -1:].float().numpy()
        assert np.abs(have - want).max() / np.abs(want).max() < tol, i
        # Feed both sides the port's greedy token, so a near-tie cannot fork them.
        jtok = jnp.asarray(got[i][:, -1].argmax(-1, keepdim=True).numpy(), jnp.int32)


def _decode_args(cfg, model):
    kv = init_program_cache(cfg, cfg.program, B, P + GEN, dtype_of(cfg), "meta")
    return (model.init_shapes(), kv, torch.empty((B, 1), dtype=torch.long, device="meta"))


def _decode_events(cfg, model, pos, device="cpu"):
    args = (*_decode_args(cfg, model), pos)
    gm = P_trace.capture_graph(build_serve_step(model, cfg), *args, device=device)
    em = P_trace._GraphEventEmitter()
    em.run(gm, P_trace._leaf_paths(args))
    ops = {str(n.target) for n in gm.graph.nodes if n.op == "call_function"}
    return [(int(e.kind), e.var, e.size, e.index) for e in em.events], ops


@pytest.mark.parametrize("arch", ARCHS)
def test_traced_decode_does_not_depend_on_the_position(arch):
    """The decode step traced at two positions (real 0-d tensors, which the
    tracer makes fake) gives the same events as at a position of no value
    (a meta tensor), on fake CPU and fake CUDA tensors alike (a host
    without CUDA traces the latter too), and its graph holds no host read
    of a tensor (``aten._local_scalar_dense``)."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, "cpu")
    first, ops = _decode_events(cfg, model, torch.tensor(P))
    assert _decode_events(cfg, model, torch.tensor(P + GEN - 2))[0] == first
    shape_only = torch.empty((), dtype=torch.long, device="meta")
    for device in ("cpu", "cuda"):
        assert _decode_events(cfg, model, shape_only, device=device)[0] == first
    assert not any("_local_scalar_dense" in op for op in ops), sorted(ops)
    if arch == "qwen3-4b":
        assert "aten.index_copy_.default" in ops  # the slot write, in place


@pytest.mark.parametrize("arch", ARCHS)
def test_step_builders_return_the_models_outputs(arch):
    cfg, model, params = _model(arch)
    tokens = _prompt(cfg)
    logits, cache = build_prefill_step(model, cfg)(params, {"tokens": tokens})
    want_logits, want_cache = model.prefill(params, {"tokens": tokens})
    assert torch.equal(logits, want_logits)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cache), tree_leaves(want_cache)))
    tok = logits[:, -1].argmax(-1, keepdim=True)
    pos = torch.tensor(P - 1)  # prefill's own cache holds P slots: overwrite the last
    got = build_serve_step(model, cfg)(params, cache, tok, pos)
    want = model.decode_step(params, want_cache, tok, pos)
    assert torch.equal(got[0], want[0])
    assert got[1] is cache  # updated in place and returned
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got[1]), tree_leaves(want[1])))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_plans_the_cache_prefill_fills(arch):
    """The decode step's planned cache (``init_program_cache`` on meta
    tensors) has the shapes and dtypes of the cache prefill returns."""
    cfg, model, params = _model(arch, "bfloat16")
    _, cache = model.prefill(params, {"tokens": _prompt(cfg)}, max_seq=P + GEN)
    planned = _decode_args(cfg, model)[1]
    assert [(tuple(t.shape), t.dtype) for t in tree_leaves(planned)] == \
        [(tuple(t.shape), t.dtype) for t in tree_leaves(cache)]


# ---------------------------------------------------- (b) serve --plan
# omega_port / omega_ref of plan_serve_steps' traces at B2 P16 (max_seq 20)
# on the smoke configs, with a band of +-5% around it.  Causes, read from
# the variables live at each peak (both come in the first layer, with
# every parameter live; the reference's parameters and the port's agree
# to 256 B there):
# - qwen3-4b prefill 1.0136: the port holds ln1's RMSNorm output (8,192 B)
#   beside the embedding gather and the RoPE product, which the reference's
#   peak holds alone;
# - qwen3-4b decode 1.0004 and mamba2-370m decode 1.0005: the port's int64
#   tokens and position (the reference's are int32) and ln1's output;
# - mamba2-370m prefill 1.0567: the port's peak comes in the first layer's
#   conv, with the in-projection's xBC, its left-padded copy and two conv
#   temporaries live (103,168 B), where the reference's comes at the
#   embedding gather.
OMEGA_RATIO = {("qwen3-4b", "prefill"): 1.0136, ("qwen3-4b", "decode"): 1.0004,
               ("mamba2-370m", "prefill"): 1.0567, ("mamba2-370m", "decode"): 1.0005}
# chi/omega: SmartPool packs both within 4% of the peak (the port's
# mamba2-370m prefill 1.0317, the largest; the reference's at most 1.0021).
CHI_GAP = 0.04


def _serve_args(arch, **kw):
    return argparse.Namespace(arch=arch, batch=B, prompt_len=P, smoke=True,
                              plan_cache=kw.get("plan_cache"))


@pytest.fixture(scope="module")
def planned():
    """Both packages' ``plan_serve_steps`` on each smoke config."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_smoke_config(arch)
        jmodel = jax_build_model(jcfg)
        cfg = get_smoke_config(arch)
        model = build_model(cfg, "cpu")
        with contextlib.redirect_stdout(io.StringIO()):
            ref = R_serve.plan_serve_steps(jmodel, jcfg, _serve_args(arch), P + GEN)
            port = serve.plan_serve_steps(model, cfg, _serve_args(arch), P + GEN)
        out[arch] = (ref, port, len(jax.tree.leaves(jmodel.init_shapes())),
                     len(tree_leaves(model.init_shapes())))
    return out


@pytest.mark.parametrize("arch,role", sorted(OMEGA_RATIO))
def test_serve_plans_match_the_reference(planned, arch, role):
    ref, port, n_ref, n_port = planned[arch]
    rt, pt = ref[role][0].trace, port[role][0].trace
    assert sum(v.size for v in pt.variables[:n_port]) == \
        sum(v.size for v in rt.variables[:n_ref])                      # parameter bytes
    ratio = pt.peak_load() / rt.peak_load()
    want = OMEGA_RATIO[(arch, role)]
    assert want * 0.95 <= ratio <= want * 1.05, ratio
    chi_port = P_solve(pt).footprint / pt.peak_load()
    chi_ref = R_solve(rt).footprint / rt.peak_load()
    assert chi_port >= 1.0 and abs(chi_port - chi_ref) <= CHI_GAP, (chi_port, chi_ref)
    key = port[role][0].program.key
    assert (key.arch, key.step_signature, key.hardware) == \
        (arch, f"{role}:b{B}p{P}s{P + GEN}:smoke", "h100_sxm")


def _serve(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        gen = serve.main(["--smoke", "--device", "cpu", "--batch", str(B), "--prompt-len",
                          str(P), "--gen", str(GEN), *argv])
    return gen, out.getvalue()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_plan_cache_solves_then_restores(arch, tmp_path):
    """The first ``serve --plan-cache`` solves both steps, the second
    restores both; planning changes no token."""
    cache = str(tmp_path / "plans")
    plain, _ = _serve("--arch", arch)
    first, text1 = _serve("--arch", arch, "--plan", "--plan-cache", cache)
    second, text2 = _serve("--arch", arch, "--plan-cache", cache)
    for role in ("prefill", "decode"):
        assert f"[plan] {role}: solved  vars=" in text1
        assert f"[plan] {role}: restored from cache  vars=" in text2
        assert f"[plan] {role}: AutoSwap@80%: " in text2
    assert sorted(p.name.split("_h100")[0] for p in (tmp_path / "plans").iterdir()) == \
        [f"{arch}_decode_b{B}p{P}s{P + GEN}_smoke", f"{arch}_prefill_b{B}p{P}s{P + GEN}_smoke"]
    assert torch.equal(first, plain) and torch.equal(second, plain)


def test_serve_colocate_reports_and_verifies(tmp_path):
    """``serve --colocate --verify`` co-schedules the two steps under one
    budget: both tenants complete, the aggregate peak sits below the summed
    isolated provisioning, and every plan and the schedule certify; the
    trace and the monitor summary are written."""
    trace, mon = tmp_path / "serve.trace.json", tmp_path / "monitor.jsonl"
    _, text = _serve("--plan-cache", str(tmp_path / "plans"), "--colocate", "--verify",
                     "--trace-out", str(trace), "--slo", "queue_wait.p99<100,name=guard",
                     "--monitor-out", str(mon))
    assert "[runtime]   qwen3-4b:prefill: overhead" in text
    assert "[runtime]   qwen3-4b:decode: overhead" in text
    assert "sharing gain" in text and "over-budget events 0" in text
    for name in ("plan qwen3-4b:prefill", "plan qwen3-4b:decode", "schedule"):
        assert f"[verify] {name}: ok" in text
    assert "[obs] SLO monitor: 1 spec(s) armed, no alerts" in text
    assert trace.exists() and mon.exists()


@pytest.mark.parametrize("plan", [False, True])
def test_serve_without_cuda_raises_unless_asked_for_the_cpu(plan, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--smoke", *(["--plan"] if plan else [])])


def test_unported_frontends_raise_naming_the_roadmap():
    cfg = get_smoke_config("qwen3-4b")
    for kw in ({"frontend": "vision_stub", "num_patch_tokens": 8}, {"is_encoder_decoder": True}):
        with pytest.raises(NotImplementedError, match="queue A item 10"):
            serve.serve_batch_struct(cfg.reduced(**kw), B, P)
