"""Training the MoE models (deepseek-v2-lite: MLA, a dense layer, then MoE
layers; llama4: interleaved dense and MoE layers of full attention) in the
port against the JAX package on the CPU, at smoke size in fp32.

The reference's loss is ``ce + 0.01 * aux``, the MoE layers' Switch aux
losses summed in fp32 (``repro/models/transformer.py:296-340, 430-448``).
Routing is discontinuous, so each comparison first holds the routing of
every MoE call equal (expert ids and ranks), each call's smallest top-k
margin above ``tests/test_torch_moe.py``'s ``MARGIN``, then the numbers to
the tolerances of ``tests/test_torch_train.py``: the loss and the aux to
1e-5 relative, every gradient to 1e-4 of its leaf's max.  Also: remat and
the offload policy change no number and route each recompute as its
forward, five ``build_train_step`` steps against the reference's jitted
step, the train launcher, and the MoE train step traced on fake tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.optim import adamw as jax_adamw
from repro_torch.configs import get_smoke_config
from repro_torch.core.offload import remat_policy_for
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.launch.steps import build_train_step
from repro_torch.models import build_model, moe
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import layer_specs
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves

DEEPSEEK, LLAMA4 = "deepseek-v2-lite-16b", "llama4-maverick-400b-a17b"
MARGIN = 1e-4                    # tests/test_torch_moe.py
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4  # tests/test_torch_train.py, smoke fp32
B, S = 2, 32
# name -> (arch, config overrides).  "dropped": deepseek smoke at capacity
# factor 0.5, where C = 8 rows an expert for 128 token-expert pairs over 8
# experts, so the busiest experts drop pairs.
CASES = {"deepseek": (DEEPSEEK, {}), "llama4": (LLAMA4, {}),
         "deepseek-dropped": (DEEPSEEK, {"capacity_factor": 0.5})}


def _setup(name: str, seed: int = 0):
    arch, over = CASES[name]
    jcfg = jax_smoke_config(arch).reduced(dtype="float32", **over)
    tcfg = get_smoke_config(arch).reduced(dtype="float32", **over)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu", torch.float32)
    return jmodel, jparams, build_model(tcfg, "cpu"), tparams, tcfg


def _batches(cfg, batch, steps):
    ds = JaxSyntheticTokens(cfg.vocab_size, S, batch, seed=0)
    return [ds.batch_at(i) for i in range(steps)]


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _ranks(idx):
    """The reference's ranks of ``idx`` [T, k] (one group): each pair's
    place among its expert's pairs, by a stable sort of the flat pairs."""
    flat = np.asarray(idx).reshape(-1)
    order = np.argsort(flat, kind="stable")
    start = np.searchsorted(flat[order], np.arange(flat.max() + 1))
    out = np.empty_like(flat)
    out[order] = np.arange(flat.size) - start[flat[order]]
    return out.reshape(idx.shape)


def _margin(probs, k: int) -> float:
    top = torch.topk(torch.as_tensor(np.asarray(probs)).float(), k + 1, dim=-1).values
    return float((top[:, k - 1] - top[:, k]).min())


def _jax_routing(jmodel, jparams, batch, monkeypatch):
    """Each MoE call's (expert ids, probabilities) in the JAX model's loss,
    through a debug callback in the reference's ``_route`` (the JAX package
    is not edited)."""
    calls = []
    orig = jax_moe._route

    def route(p, xt, cfg):
        gates, idx, aux = orig(p, xt, cfg)
        logits = jnp.einsum("td,de->te", xt.astype(jnp.float32), p["router"])
        probs = (jax.nn.sigmoid(logits) if cfg.router_type == "sigmoid"
                 else jax.nn.softmax(logits, axis=-1))
        jax.debug.callback(lambda i, pr: calls.append((np.array(i), np.array(pr))),
                           idx, probs, ordered=True)
        return gates, idx, aux

    monkeypatch.setattr(jax_moe, "_route", route)
    jmodel.loss(jparams, _jb(batch), remat=False)
    jax.effects_barrier()
    monkeypatch.setattr(jax_moe, "_route", orig)
    return calls


def _assert_routing_equal(jcalls, tcalls, k: int):
    """Every MoE call's margin above MARGIN, then its ids and ranks equal."""
    assert len(jcalls) == len(tcalls) > 0
    margins = [_margin(probs, k) for _, probs in jcalls]
    assert min(margins) > MARGIN, f"near-tie in the router's top-{k}: margins {margins}"
    for (jidx, _), rec in zip(jcalls, tcalls):
        np.testing.assert_array_equal(rec["idx"].numpy(), jidx)
        np.testing.assert_array_equal(rec["rank"].numpy(), _ranks(jidx))


def _leaf_rel(got, want_np_tree, tcfg):
    want = tree_leaves(params_from_jax(want_np_tree, tcfg, "cpu", torch.float32))
    return [((g.detach().float() - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
            for g, w in zip(got, want)]


def _loss_and_grads(model, params, batch, **kw):
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = model.loss(params, batch, **kw)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        list(torch.autograd.grad(loss, leaves))


# ------------------------------------------------------------ loss, grads
@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_grads_match_jax(name, monkeypatch):
    """``Model.loss`` (remat, as ``train.main`` trains) and every gradient
    against ``jax.value_and_grad`` of the reference's loss, routing held
    equal first; the "dropped" case must drop pairs beyond the capacity
    (random routers leave the smoke models' experts unevenly loaded, so
    the other cases may drop some too)."""
    jmodel, jparams, tmodel, tparams, tcfg = _setup(name)
    batch = _batches(tcfg, B, 1)[0]
    jcalls = _jax_routing(jmodel, jparams, batch, monkeypatch)
    tcalls = []
    with moe.routing_hook(tcalls.append):
        tloss, tm, grads = _loss_and_grads(tmodel, tparams, _tb(batch))
    n_moe = sum(spec.ffn == "moe" for spec in layer_specs(tcfg.program))
    fwd = tcalls[:n_moe]                              # then the recomputes, in backward
    _assert_routing_equal(jcalls, fwd, tcfg.top_k)
    dropped = sum(int((r["rank"] >= r["capacity"]).sum()) for r in fwd)
    print(f"{name}: {dropped} of {sum(r['rank'].numel() for r in fwd)} pairs dropped")
    assert dropped > 0 or name != "deepseek-dropped"
    (jloss, jm), jgrads = jax.value_and_grad(lambda p: jmodel.loss(p, _jb(batch)),
                                             has_aux=True)(jparams)
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    assert abs(float(tm["aux"]) - float(jm["aux"])) <= LOSS_TOL * abs(float(jm["aux"]))
    assert abs(float(tm["ce"]) - float(jm["ce"])) <= LOSS_TOL * abs(float(jm["ce"]))
    assert tm["aux"].dtype == torch.float32 and float(tm["aux"]) > 0
    assert float(tloss) == float(tm["ce"] + 0.01 * tm["aux"])
    rel = _leaf_rel(grads, jax.tree.map(np.asarray, jgrads), tcfg)
    assert len(rel) == len(grads) and max(rel) < GRAD_TOL, max(rel)


@pytest.mark.parametrize("name", ["deepseek", "llama4"])
def test_remat_and_the_policy_change_no_number_and_route_each_recompute_alike(name):
    """The loss, the aux and every gradient bit-equal without remat, with
    remat and under an offload policy; each layer's recompute in backward
    routes exactly as its forward did (a recompute that routed otherwise
    would give another function's gradient), and its record holds no
    autograd graph (under remat a recompute's graph is never run, so a
    record that held it would keep the layer's saved tensors alive to the
    end of the step); the policy moves each MoE
    layer's labels as a dense layer's, and the aux's gradient reaches the
    router."""
    _, _, tmodel, tparams, tcfg = _setup(name)
    batch = _tb(_batches(tcfg, B, 1)[0])
    n_moe = sum(spec.ffn == "moe" for spec in layer_specs(tcfg.program))
    policy = remat_policy_for(["block_in", "ffn_out"]).policy()
    runs = {}
    for tag, kw in (("plain", dict(remat=False)), ("remat", {}),
                    ("policy", dict(remat_policy=policy))):
        calls = []
        with moe.routing_hook(calls.append):
            runs[tag] = _loss_and_grads(tmodel, tparams, batch, **kw)
        want = n_moe if tag == "plain" else 2 * n_moe
        assert len(calls) == want, (tag, len(calls))
        # a record holds no graph: a recompute's would keep its saved tensors
        assert all(rec["probs"].grad_fn is None for rec in calls)
        for fwd, rec in zip(calls[:n_moe], reversed(calls[n_moe:])):
            assert torch.equal(fwd["idx"], rec["idx"]) and torch.equal(fwd["rank"], rec["rank"])
    for tag in ("remat", "policy"):
        loss, m, grads = runs[tag]
        assert torch.equal(loss, runs["plain"][0])
        assert torch.equal(m["aux"], runs["plain"][1]["aux"])
        assert all(torch.equal(a, b) for a, b in zip(grads, runs["plain"][2])), tag
    act = B * S * tcfg.d_model * 4
    assert policy.bytes_d2h == policy.bytes_h2d == 2 * tcfg.num_layers * act
    # The aux's share of the router's gradient: the loss without it differs.
    leaves = tree_leaves(tparams)
    router = next(i for i, t in enumerate(leaves)
                  if t is tparams["blocks"][1]["moe"]["router"])
    loss, m = tmodel.loss(tparams, batch)
    g_ce = torch.autograd.grad(m["ce"], leaves[router])[0]
    assert not torch.allclose(g_ce, runs["remat"][2][router])


# -------------------------------------------------------------- the step
@pytest.mark.parametrize("name,accum", [("deepseek", 1), ("deepseek", 2), ("llama4", 1),
                                        ("llama4", 2)])
def test_five_train_steps_match_jax(name, accum):
    """Losses to 1e-5, the grad norm to 1e-4, the final params to 1e-4 of
    each leaf's max (as ``tests/test_torch_train.py``); the metrics carry
    the last micro-batch's ce and aux, as the reference's."""
    jmodel, jparams, tmodel, tparams, tcfg = _setup(name)
    jstep = jax.jit(jax_build_train_step(jmodel, jmodel.cfg, accum_steps=accum))
    tstep = build_train_step(tmodel, tcfg, accum_steps=accum)
    jopt, topt = jax_adamw.adamw_init(jparams), adamw.adamw_init(tparams)
    for i, b in enumerate(_batches(tcfg, 4, 5)):
        jparams, jopt, jm = jstep(jparams, jopt, _jb(b), jnp.asarray(i, jnp.int32))
        tparams, topt, tm = tstep(tparams, topt, _tb(b), i)
        for key, tol in (("loss", LOSS_TOL), ("ce", LOSS_TOL), ("aux", LOSS_TOL),
                         ("grad_norm", GRAD_TOL)):
            assert abs(float(tm[key]) - float(jm[key])) <= tol * abs(float(jm[key])), (i, key)
    assert topt.count == int(jopt.count) == 5
    rel = _leaf_rel(tree_leaves(tparams), jax.tree.map(np.asarray, jparams), tcfg)
    assert max(rel) < GRAD_TOL, max(rel)


# ---------------------------------------------------------- the launcher
@pytest.mark.parametrize("arch", [DEEPSEEK, LLAMA4])
def test_train_main_trains_the_moe_smoke_models(arch, capsys):
    ops.reset_launch_counts()
    losses = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
                         "--batch", "2", "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert out.count("step ") == 3 and "done: first-loss" in out
    assert all(n == 0 for n in ops.launch_counts().values())  # plain versions only


def test_train_loop_takes_a_cut_config_under_its_own_plan_key(tmp_path, capsys):
    """``train.train`` trains any config, here a 2-layer cut of the deepseek
    smoke model named apart; its plan is filed under the cut's name, so it
    neither restores nor overwrites the smoke model's."""
    smoke = get_smoke_config(DEEPSEEK)
    (dense,), _ = smoke.program[0]
    (moe_spec,), _ = smoke.program[1]
    cut = smoke.reduced(name="deepseek-v2-lite-smoke-cut2", num_layers=2,
                        program=(((dense,), 1), ((moe_spec,), 1)))
    run = train.train(cut, steps=2, batch=2, seq=16, device="cpu", plan_cache=str(tmp_path),
                      log_every=1)
    assert len(run.losses) == 2 and all(np.isfinite(run.losses))
    assert all(m["aux"] > 0 and np.isfinite(m["ce"]) for m in run.metrics)
    assert [m["ce"] + 0.01 * m["aux"] for m in run.metrics] == pytest.approx(run.losses, 1e-6)
    train.main(["--arch", DEEPSEEK, "--smoke", "--device", "cpu", "--steps", "1",
                "--batch", "2", "--seq", "16", "--plan-cache", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("(restored from cache)") == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 2 and any("cut2" in n for n in names), names
    again = train.train(cut, steps=1, batch=2, seq=16, device="cpu", plan_cache=str(tmp_path))
    assert "(restored from cache)" in capsys.readouterr().out
    assert again.losses[0] == run.losses[0]


# ------------------------------------------------------------- the trace
def test_moe_train_step_traces_on_fake_tensors():
    """The deepseek smoke loss and its gradient under remat, traced on fake
    tensors: the dispatch's forward ops (the stable sort, ``searchsorted``,
    the ``scatter_`` of the slots, ``index_put_`` into the buffer,
    ``index_select`` of the rows) and their backward (``index_add`` into the
    experts' output, the ``index`` gather of the buffer's rows) each trace and
    are priced; no host read, no launch."""
    import repro_torch.core.trace as P

    cfg = get_smoke_config(DEEPSEEK)
    model = build_model(cfg, "cpu")
    params = model.init_shapes(torch.float32)
    batch = {k: torch.empty(B, S, dtype=torch.long, device="meta") for k in ("tokens", "labels")}

    def step(p, b):
        leaves = tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        return torch.autograd.grad(model.loss(p, b)[0], leaves)

    ops.reset_launch_counts()
    gm = P.capture_graph(step, params, batch)
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"]
    targets = {str(n.target) for n in nodes}
    dispatch = ("aten.sort.stable", "aten.searchsorted.Tensor", "aten.scatter_.src",
                "aten.index_put_.default", "aten.index_select.default",
                "aten.index_add.default", "aten.index.Tensor")
    for op in dispatch:
        assert op in targets, (op, sorted(targets))
    for node in nodes:
        if str(node.target) in dispatch:
            flops, nbytes = P._node_cost(node)
            assert flops > 0 and nbytes > 0, node
    host_reads = ("aten.nonzero", "aten.masked_select", "aten._local_scalar_dense", "aten.item")
    assert not [t for t in targets if t.startswith(host_reads)]
    assert not any(ops.launch_counts().values())
    n_moe = sum(spec.ffn == "moe" for spec in layer_specs(cfg.program))
    # each MoE layer's forward runs twice: the step's, then the recompute's
    assert sum(str(n.target) == "aten.sort.stable" for n in nodes) == 2 * n_moe
    tr = P.trace_graph(gm, P._leaf_paths((params, batch)))
    assert tr.peak_load() > 0 and len(tr.op_costs) > 0
