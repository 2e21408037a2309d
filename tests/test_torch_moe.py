"""The port's MoE FFN (``repro_torch.models.moe``) and the MoE models
(deepseek-v2-lite and llama4 smoke) against the JAX package on the CPU.

Routing is discontinuous: top-k over the router's probabilities can flip
where two of them are nearly equal, and XLA's and ATen's CPU sums differ in
their last bits.  So each comparison of routing first asserts that the
smallest gap between the k-th and (k+1)-th probability of its inputs is
above ``MARGIN``, which reports a near-tie as such; the routing (expert ids,
ranks, kept pairs) is then held equal, and the outputs to ``TOL``, the fp32
tolerance of ``tests/test_kernels.py``, relative to the largest reference
value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import build_model, layers, moe
from repro_torch.models.convert import cache_from_jax, params_from_jax

TOL = 2e-5
MARGIN = 1e-4
DEEPSEEK, LLAMA4 = "deepseek-v2-lite-16b", "llama4-maverick-400b-a17b"


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ranks(idx, groups: int = 1):
    """The reference's ranks (``repro/models/moe.py:201-206``) of the pairs
    of ``idx`` [T, k], in token order: each pair's place among the pairs of
    its expert in its group, by a stable sort of the flattened pairs."""
    T, k = idx.shape
    flat = np.asarray(idx).reshape(groups, -1)
    out = np.empty_like(flat)
    for g, row in enumerate(flat):
        order = np.argsort(row, kind="stable")
        sorted_e = row[order]
        start = np.searchsorted(sorted_e, np.arange(idx.max() + 1))
        out[g, order] = np.arange(row.size) - start[sorted_e]
    return out.reshape(T, k)


def _margin(probs, k: int) -> float:
    """The smallest gap, over the rows of ``probs`` [T, E], between the k-th
    and the (k+1)-th largest probability: how far the routing is from a tie
    that a last-bit difference could flip."""
    top = torch.topk(torch.as_tensor(probs).float(), k + 1, dim=-1).values
    return float((top[:, k - 1] - top[:, k]).min())


def _jax_probs(p, xt, cfg):
    logits = np.asarray(xt, np.float32) @ np.asarray(p["router"], np.float32)
    if cfg.router_type == "sigmoid":
        return 1 / (1 + np.exp(-logits))
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _moe_params(cfg_name: str, layer: int):
    """One MoE layer's params of a smoke model, from the JAX init, on both sides."""
    jcfg, tcfg = jax_smoke_config(cfg_name), get_smoke_config(cfg_name)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams["blocks"][layer]["moe"]


def _case(name):
    """(jax cfg, port cfg, jax moe params, port moe params, x [B,S,D] numpy)."""
    rng = np.random.default_rng(7)
    if name == "llama4-sigmoid-top1":
        jcfg, tcfg, jparams, tp = _moe_params(LLAMA4, 1)   # (dense, moe): layer 1
        jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["l1"]["moe"])
    else:
        jcfg, tcfg, jparams, tp = _moe_params(DEEPSEEK, 1)  # layer 0 dense, then MoE
        jp = jax.tree.map(lambda a: a[0], jparams["blocks"][1]["l0"]["moe"])
    shape = (3, 1, jcfg.d_model) if name == "decode" else (2, 12, jcfg.d_model)
    x = rng.standard_normal(shape, dtype=np.float32)
    if name == "dropped":
        # A feature every token carries, which the router reads as a bias of
        # +3 toward expert 0: nearly every token picks it, beyond capacity.
        x[..., 0] = 1.0
        router = np.array(jp["router"])
        router[0] = 0.0
        router[0, 0] = 3.0
        jp = dict(jp, router=jnp.asarray(router))
        tp = dict(tp, router=torch.from_numpy(router))
    return jcfg, tcfg, jp, tp, x


CASES = ["prefill", "decode", "dropped", "llama4-sigmoid-top1"]


def test_capacity_is_the_reference_formula():
    cfg = get_config(DEEPSEEK)
    assert moe.capacity(4 * 512, cfg) == 288  # prefill B4 P512
    assert moe.capacity(4, cfg) == 8          # decode B4
    for T in (1, 7, 24, 100, 2048, 4096):
        C = int(np.ceil(T * cfg.top_k / cfg.num_experts * cfg.capacity_factor))
        assert moe.capacity(T, cfg) == max(8, -(-C // 8) * 8)


@pytest.mark.parametrize("name", CASES)
def test_route_matches_jax(name):
    """Gates and ids equal the reference's ``_route``'s; the aux loss within TOL."""
    jcfg, tcfg, jp, tp, x = _case(name)
    xt = x.reshape(-1, jcfg.d_model)
    margin = _margin(_jax_probs(jp, xt, jcfg), jcfg.top_k)
    print(f"{name}: smallest top-{jcfg.top_k} margin {margin:.3e}")
    assert margin > MARGIN, f"near-tie in the router's top-{jcfg.top_k}: margin {margin:.3e}"
    jg, ji, ja = jax_moe._route(jp, jnp.asarray(xt), jcfg)
    tg, ti, ta, tprobs = moe._route(tp, torch.from_numpy(xt), tcfg)
    assert _rel(tprobs, _jax_probs(jp, xt, jcfg)) < TOL
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tg.dtype == torch.float32 and _rel(tg, jg) < TOL
    assert abs(float(ta) - float(ja)) <= TOL * abs(float(ja))


@pytest.mark.parametrize("name", CASES)
def test_apply_moe_matches_jax(name):
    """Output and aux loss within TOL; every pair's expert and rank equal
    the reference's, so the same pairs are kept; the "dropped" case must
    drop pairs beyond the capacity."""
    jcfg, tcfg, jp, tp, x = _case(name)
    records = []
    with moe.routing_hook(records.append):
        tout, taux = moe.apply_moe(tp, torch.from_numpy(x), tcfg)
    jout, jaux = jax_moe.apply_moe(jp, jnp.asarray(x), jcfg)
    (rec,) = records
    xt = x.reshape(-1, jcfg.d_model)
    margin = _margin(rec["probs"], jcfg.top_k)
    assert margin > MARGIN, f"near-tie in the router's top-{jcfg.top_k}: margin {margin:.3e}"
    _, jidx, _ = jax_moe._route(jp, jnp.asarray(xt), jcfg)
    np.testing.assert_array_equal(rec["idx"].numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(rec["rank"].numpy(), _ranks(np.asarray(jidx)))
    C = rec["capacity"]
    assert C == moe.capacity(xt.shape[0], tcfg)
    dropped = int((rec["rank"] >= C).sum())
    assert (dropped > 0) == (name == "dropped"), dropped
    assert tout.shape == x.shape and _rel(tout, jout) < TOL
    assert abs(float(taux) - float(jaux)) <= TOL * abs(float(jaux))


def test_apply_moe_in_bf16_matches_jax():
    """bf16 activations and experts, fp32 router: within bf16's 2e-2."""
    jcfg, tcfg, jp, tp, x = _case("prefill")
    assert tp["router"].dtype == torch.float32
    bf = {k: (v.to(torch.bfloat16) if k != "router" else v) if isinstance(v, torch.Tensor)
          else {n: w.to(torch.bfloat16) for n, w in v.items()} for k, v in tp.items()}
    tout, _ = moe.apply_moe(bf, torch.from_numpy(x).to(torch.bfloat16), tcfg)
    jout, _ = jax_moe.apply_moe(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    assert tout.dtype == torch.bfloat16 and _rel(tout, jout) < 2e-2


def test_apply_moe_has_static_shapes_and_launches_no_kernel():
    """The dispatch traces on fake tensors (no data-dependent shape, no host
    read) and runs no kernel of the port."""
    from repro_torch.core.trace import capture_graph

    _, tcfg, _, tp, x = _case("dropped")
    ops.reset_launch_counts()
    gm = capture_graph(lambda p, a: moe.apply_moe(p, a, tcfg)[0], tp, torch.from_numpy(x),
                       device="cpu")
    targets = {str(n.target) for n in gm.graph.nodes if n.op == "call_function"}
    assert "aten.sort.stable" in targets and "aten.bmm.default" in targets, sorted(targets)
    host_reads = ("aten.nonzero", "aten.masked_select", "aten._local_scalar_dense", "aten.item")
    assert not [t for t in targets if t.startswith(host_reads)], targets
    assert not any(ops.launch_counts().values())


# ------------------------------------------------------------ the models
def _route_recorder(monkeypatch):
    """Wrap the reference's ``_route`` so that each MoE call of the JAX model
    hands its expert ids and probabilities to the test (a debug callback,
    so it works inside the scan over layers); the JAX package is not edited."""
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
    return calls


@pytest.mark.parametrize("arch", [DEEPSEEK, LLAMA4])
def test_moe_model_serving_matches_jax(arch, monkeypatch):
    """The smoke model's prefill and 4 greedy decode steps against the JAX
    model: logits and every layer's cache within TOL, the routing of every
    MoE call equal (ids and ranks), each call's top-k margin above MARGIN.
    deepseek: MLA + dense layer, then MLA + MoE (softmax top-2, 2 shared
    experts, untied head); llama4: interleaved dense and MoE layers of
    full attention (sigmoid top-1, 1 shared expert)."""
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    tmodel = build_model(tcfg, "cpu")
    jcalls = _route_recorder(monkeypatch)
    tcalls = []
    B, P, steps = 2, 12, 4
    max_seq = P + steps
    # The prompt of seed 3 puts a top-2 pair of deepseek's first MoE call
    # within 5.8e-5 of a tie, which the margin check reports; seed 4's is
    # clear of it.
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, P))
    with moe.routing_hook(tcalls.append):
        jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                                         max_seq=max_seq)
        tlogits, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, max_seq)
        assert _rel(tlogits, jlogits) < TOL
        for i in range(steps):
            jtok = np.array(jnp.argmax(jlogits[:, -1], axis=-1))[:, None]
            np.testing.assert_array_equal(tlogits[:, -1].argmax(-1, keepdim=True).numpy(), jtok)
            jlogits, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(jtok, jnp.int32),
                                                 jnp.int32(P + i))
            tlogits, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(jtok), P + i)
            assert _rel(tlogits, jlogits) < TOL, f"step {i}"
    jax.effects_barrier()
    n_moe = sum(spec.ffn == "moe" for unit, reps in jcfg.program for _ in range(reps)
                for spec in unit)
    assert len(tcalls) == len(jcalls) == n_moe * (1 + steps)
    margins = [_margin(probs, jcfg.top_k) for _, probs in jcalls]
    print(f"{arch}: smallest top-{jcfg.top_k} margin over {len(jcalls)} MoE calls "
          f"{min(margins):.3e}")
    assert min(margins) > MARGIN, f"near-tie in the router's top-k: margins {margins}"
    for (jidx, _), rec in zip(jcalls, tcalls):
        np.testing.assert_array_equal(rec["idx"].numpy(), jidx)
        np.testing.assert_array_equal(rec["rank"].numpy(), _ranks(jidx))
    jlayers = cache_from_jax(jcache, jcfg)
    assert len(jlayers) == len(tcache) == jcfg.num_layers
    for jl, tl in zip(jlayers, tcache):
        assert jl.keys() == tl.keys() and jl["kv"].keys() == tl["kv"].keys()
        for name in tl["kv"]:
            assert _rel(tl["kv"][name], jl["kv"][name]) < TOL, name


def test_untied_head_in_logits_and_loss():
    """deepseek's head is its own table (its smoke config ties them, so the
    test unties it, as the full config does): ``lm_logits`` and the chunked
    loss read it, as the reference's do, not the token table."""
    assert not get_config(DEEPSEEK).tie_embeddings
    jcfg = jax_smoke_config(DEEPSEEK).reduced(tie_embeddings=False)
    tcfg = get_smoke_config(DEEPSEEK).reduced(tie_embeddings=False)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    assert set(tparams["embed"]) == {"tok", "head"}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 20, jcfg.d_model), dtype=np.float32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 20))
    labels[0, 3] = -1
    logits = layers.lm_logits(tparams["embed"], torch.from_numpy(x), tcfg)
    assert _rel(logits, jax_layers.lm_logits(jparams["embed"], jnp.asarray(x), jcfg)) < TOL
    tied = layers.lm_logits({"tok": tparams["embed"]["tok"]}, torch.from_numpy(x), tcfg)
    assert _rel(tied, logits) > 0.1
    ce = layers.chunked_softmax_xent(torch.from_numpy(x), tparams["embed"],
                                     torch.from_numpy(labels), tcfg, chunk=8)
    want = jax_layers.chunked_softmax_xent(jnp.asarray(x), jparams["embed"],
                                           jnp.asarray(labels, jnp.int32), jcfg, chunk=8)
    assert abs(float(ce) - float(want)) <= TOL * abs(float(want))


def test_init_keeps_routers_fp32():
    """Experts in cfg.dtype, the router fp32, the shared experts'
    width f * num_shared_experts, as the reference's ``init_moe``."""
    cfg = get_config(DEEPSEEK)
    p = build_model(cfg, "cpu").init_shapes()["blocks"][1]["moe"]
    assert p["router"].dtype == torch.float32 and p["router"].shape == (2048, 64)
    assert p["w_gate"].dtype == torch.bfloat16 and p["w_gate"].shape == (64, 2048, 1408)
    assert p["w_down"].shape == (64, 1408, 2048)
    assert p["shared"]["w_up"].shape == (2048, 2 * 1408)
