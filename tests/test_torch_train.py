"""The port's training slice (repro_torch) against the JAX package on the CPU.

The same parameters (the JAX ``Model.init`` pytree carried across with
``params_from_jax`` as fp32 masters) and the same ``SyntheticTokens``
batches go through ``Model.loss`` and ``jax.value_and_grad`` on one side
and the port's ``Model.loss`` and autograd on the other: the loss and every
gradient, then five ``build_train_step`` steps.  Also: AdamW, the clip, the
schedules, the data pipeline, the chunked loss, and the train driver.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import LayerSpec as JaxLayerSpec
from repro.data import Prefetcher as JaxPrefetcher
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.data import host_shard_info as jax_host_shard_info
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.optim import adamw as jax_adamw
from repro.optim import schedule as jax_schedule
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import LayerSpec
from repro_torch.data import Prefetcher, SyntheticTokens, host_shard_info
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.launch.steps import build_train_step
from repro_torch.models import build_model, layers
from repro_torch.models.convert import adamw_from_jax, params_from_jax
from repro_torch.optim import adamw, schedule
from repro_torch.tree import tree_leaves

ARCH = "qwen3-4b"
QUICKSTART = dict(name="quickstart", num_layers=4, d_model=256, num_heads=8, num_kv_heads=4,
                  head_dim=32, d_ff=1024, vocab_size=8192)  # examples/quickstart.py


def _configs(which: str, dtype: str):
    """(JAX config, port config, batch, seq) of the smoke or quickstart setup."""
    if which == "smoke":
        return (jax_smoke_config(ARCH).reduced(dtype=dtype),
                get_smoke_config(ARCH).reduced(dtype=dtype), 2, 32)
    return (jax_smoke_config(ARCH).reduced(
                program=(((JaxLayerSpec(attn="full", ffn="dense"),), 4),), dtype=dtype,
                **QUICKSTART),
            get_smoke_config(ARCH).reduced(
                program=(((LayerSpec(attn="full", ffn="dense"),), 4),), dtype=dtype,
                **QUICKSTART), 8, 256)


def _setup(which: str, dtype: str, seed: int = 0):
    jcfg, tcfg, B, S = _configs(which, dtype)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu", torch.float32)
    return jmodel, jparams, build_model(tcfg, "cpu"), tparams, tcfg, B, S


def _batches(cfg, B, S, steps):
    ds = JaxSyntheticTokens(cfg.vocab_size, S, B, seed=0)
    return [ds.batch_at(i) for i in range(steps)]


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _leaf_rel(got_tree, want_np_tree, tcfg):
    """Per leaf: max |got - want| / max |want|, want carried into the port's layout."""
    want = tree_leaves(params_from_jax(want_np_tree, tcfg, "cpu", torch.float32))
    return [((g.detach().float() - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
            for g, w in zip(tree_leaves(got_tree), want)]


# ------------------------------------------------------------ loss, grads
# fp32: the same arithmetic in another order, measured 1.1e-7 (loss) and at
# most 4.8e-6 of a leaf's max (grads) on the quickstart config.  bf16 (the
# activations rounded at other places in the two frameworks, fp32 masters on
# both sides): measured 3.2e-5 (loss) and at most 0.038 of a leaf's max on
# smoke, held to 1e-3 and 0.1.
@pytest.mark.parametrize("which,dtype,loss_tol,grad_tol", [
    ("smoke", "float32", 1e-5, 1e-4),
    ("quickstart", "float32", 1e-5, 1e-4),
    ("smoke", "bfloat16", 1e-3, 0.1),
])
def test_loss_and_grads_match_jax(which, dtype, loss_tol, grad_tol):
    jmodel, jparams, tmodel, tparams, tcfg, B, S = _setup(which, dtype)
    batch = _batches(tcfg, B, S, 1)[0]
    (jloss, jm), jgrads = jax.value_and_grad(lambda p: jmodel.loss(p, _jb(batch)),
                                             has_aux=True)(jparams)
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    tloss, tm = tmodel.loss(tparams, _tb(batch))
    grads = torch.autograd.grad(tloss, leaves)
    tloss = float(tloss.detach())
    assert abs(tloss - float(jloss)) <= loss_tol * abs(float(jloss))
    assert float(tm["ce"].detach()) == tloss and float(tm["aux"]) == float(jm["aux"]) == 0.0
    rel = _leaf_rel(grads, jax.tree.map(np.asarray, jgrads), tcfg)
    assert len(rel) == len(leaves) and max(rel) < grad_tol, max(rel)


def test_remat_changes_no_number_and_policy_raises():
    _, _, tmodel, tparams, tcfg, B, S = _setup("smoke", "float32")
    batch = _tb(_batches(tcfg, B, S, 1)[0])
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    out = []
    for remat in (True, False):
        loss, _ = tmodel.loss(tparams, batch, remat=remat)
        out.append([loss.detach(), *torch.autograd.grad(loss, leaves)])
    assert all(torch.equal(a, b) for a, b in zip(*out))
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        tmodel.loss(tparams, batch, remat_policy=object())


def test_model_init_stores_masters_when_asked():
    cfg = get_smoke_config(ARCH).reduced(dtype="bfloat16")
    model = build_model(cfg, "cpu")
    serve = model.init(torch.Generator("cpu").manual_seed(0))
    masters = model.init(torch.Generator("cpu").manual_seed(0), dtype=torch.float32)
    for s, m in zip(tree_leaves(serve), tree_leaves(masters)):
        assert m.dtype == torch.float32
        assert s.dtype == (torch.bfloat16 if s.ndim >= 2 else torch.float32)
        assert torch.equal(s, m.to(s.dtype))  # the same draw, stored two ways


# -------------------------------------------------------------- the step
@pytest.mark.parametrize("accum", [1, 2])
def test_five_train_steps_match_jax(accum):
    """Losses to 1e-5; final params to 1e-4 of each leaf's max (AdamW's first
    steps are near sign(g) lr, so gradients that differ in the last digits
    move a parameter by at most lr where g is near 0)."""
    jmodel, jparams, tmodel, tparams, tcfg, _, S = _setup("smoke", "float32")
    B = 4
    jstep = jax.jit(jax_build_train_step(jmodel, jmodel.cfg, accum_steps=accum))
    tstep = build_train_step(tmodel, tcfg, accum_steps=accum)
    jopt = jax_adamw.adamw_init(jparams)
    topt = adamw.adamw_init(tparams)
    for i, b in enumerate(_batches(tcfg, B, S, 5)):
        jparams, jopt, jm = jstep(jparams, jopt, _jb(b), jnp.asarray(i, jnp.int32))
        tparams, topt, tm = tstep(tparams, topt, _tb(b), i)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-4 * float(jm["grad_norm"])
    assert topt.count == int(jopt.count) == 5
    rel = _leaf_rel(tparams, jax.tree.map(np.asarray, jparams), tcfg)
    assert max(rel) < 1e-4, max(rel)
    assert all(t.grad is None for t in tree_leaves(tparams))


# -------------------------------------------------------------- optimizer
def _tree_pair(rng, shapes):
    arrays = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    return ({f"p{i}": jnp.asarray(a) for i, a in enumerate(arrays)},
            {f"p{i}": torch.from_numpy(a.copy()) for i, a in enumerate(arrays)})


BF16 = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _bf16_steps_apart(got, want):
    """|got - want| in bf16 steps at the leaf's scale: the spacing of bf16
    numbers at max|want| (8 significant bits)."""
    top = float(np.abs(want).max())
    step = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else np.finfo(np.float32).tiny
    return np.abs(got - want) / step


@pytest.mark.parametrize("gscale,max_norm,steps,lr,shapes,pdt,mdt", [
    pytest.param(0.01, 1.0, 3, 1e-2, [(7, 5), (16,), (3, 4, 2)], "fp32", "fp32", id="0.01-1.0"),
    pytest.param(10.0, 1.0, 3, 1e-2, [(7, 5), (16,), (3, 4, 2)], "fp32", "fp32", id="10.0-1.0"),
    pytest.param(10.0, None, 3, 1e-2, [(7, 5), (16,), (3, 4, 2)], "fp32", "fp32", id="10.0-None"),
    *(pytest.param(0.01, 1.0, 5, 3e-4, [(256, 512), (7, 5), (16,), (3, 4, 2)], pdt, mdt,
                   id=f"params-{pdt}-moments-{mdt}")
      for pdt in ("fp32", "bf16") for mdt in ("fp32", "bf16")),
])
def test_adamw_matches_jax(gscale, max_norm, steps, lr, shapes, pdt, mdt):
    """Steps with the clip idle, active, and off, on fp32 leaves; then the
    four (params, moments) dtype cases on a [256, 512] leaf beside the small
    ones, where the reference rounds each stored result once.  fp32 leaves
    hold rtol 1e-5; bf16 params may differ from JAX in at most 0.01% of
    elements, bf16 moments in at most 1%, each by one bf16 step.  Every
    array is copied before either package sees it: the port updates in
    place, and ``torch.from_numpy`` and ``jnp.asarray`` may share a buffer."""
    (jp_dt, tp_dt), (jm_dt, tm_dt) = BF16[pdt], BF16[mdt]

    def pair(rng, scale=1.0):
        arrays = [rng.standard_normal(s, dtype=np.float32) * np.float32(scale) for s in shapes]
        t = {f"p{i}": torch.from_numpy(a.copy()).to(tp_dt) for i, a in enumerate(arrays)}
        return {k: jnp.asarray(x.float().numpy().copy(), dtype=jp_dt) for k, x in t.items()}, t

    rng = np.random.default_rng(0)
    jp, tp = pair(rng)
    jstate, tstate = jax_adamw.adamw_init(jp, jm_dt), adamw.adamw_init(tp, tm_dt)
    for _ in range(steps):
        jg, tg = pair(rng, gscale)
        jp, jstate, jm = jax_adamw.adamw_step(jp, jg, jstate, lr, max_grad_norm=max_norm)
        tp, tstate, tm = adamw.adamw_step(tp, tg, tstate, lr, max_grad_norm=max_norm)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    for name, tree_t, tree_j, dt in (("params", tp, jp, pdt), ("m", tstate.m, jstate.m, mdt),
                                     ("v", tstate.v, jstate.v, mdt)):
        got = [tree_t[k].float().numpy() for k in tree_j]
        want = [np.asarray(tree_j[k], dtype=np.float32) for k in tree_j]
        if dt == "fp32":
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
            continue
        apart = np.concatenate([_bf16_steps_apart(g, w).ravel() for g, w in zip(got, want)])
        share = 1e-4 if name == "params" else 1e-2
        assert apart.max() <= 1, (name, float(apart.max()))
        assert np.count_nonzero(apart) <= share * apart.size, (name, np.count_nonzero(apart))
    assert tstate.count == int(jstate.count) == steps


def test_adamw_fp32_updates_in_place():
    """At fp32 the update allocates no leaf-sized temporary for p, m or v:
    each is rewritten where it lies."""
    rng = np.random.default_rng(2)
    _, tp = _tree_pair(rng, [(64, 32), (16,)])
    _, tg = _tree_pair(rng, [(64, 32), (16,)])
    state = adamw.adamw_init(tp)
    before = [t.data_ptr() for tree in (tp, state.m, state.v) for t in tree.values()]
    tp, state, _ = adamw.adamw_step(tp, tg, state, 1e-2)
    after = [t.data_ptr() for tree in (tp, state.m, state.v) for t in tree.values()]
    assert after == before
    assert all(t.dtype == torch.float32 for tree in (tp, state.m, state.v) for t in tree.values())
    assert float(state.m["p0"].abs().max()) > 0


def test_clip_by_global_norm_matches_jax_in_place():
    rng = np.random.default_rng(1)
    jg, tg = _tree_pair(rng, [(9, 3), (5,)])
    want, jnorm = jax_adamw.clip_by_global_norm(jg, 0.5)
    ptrs = {k: t.data_ptr() for k, t in tg.items()}
    got, tnorm = adamw.clip_by_global_norm(tg, 0.5)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    for k in want:
        assert got[k].data_ptr() == ptrs[k]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


def test_adamw_state_carries_across():
    jmodel, jparams, _, tparams, tcfg, _, _ = _setup("smoke", "float32")
    state = jax_adamw.adamw_init(jparams)
    state = jax_adamw.AdamWState(jax.tree.map(lambda a: a + 1.0, state.m),
                                 jax.tree.map(lambda a: a + 2.0, state.v), jnp.asarray(7))
    got = adamw_from_jax(jax.tree.map(np.asarray, state), tcfg, "cpu")
    assert got.count == 7
    for m, v, p in zip(tree_leaves(got.m), tree_leaves(got.v), tree_leaves(tparams)):
        assert m.shape == p.shape and m.dtype == v.dtype == torch.float32
        assert bool((m == 1.0).all()) and bool((v == 2.0).all())


@pytest.mark.parametrize("kind", ["cosine", "warmup"])
def test_schedules_match_jax(kind):
    if kind == "cosine":
        jfn, tfn = jax_schedule.cosine_schedule(3e-4, 50), schedule.cosine_schedule(3e-4, 50)
    else:
        jfn = jax_schedule.linear_warmup_cosine(3e-4, 10, 50)
        tfn = schedule.linear_warmup_cosine(3e-4, 10, 50)
    for step in (0, 1, 5, 10, 11, 30, 50, 80):
        want = float(jfn(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(float(tfn(step)), want, rtol=1e-6)


# ------------------------------------------------------------------ data
def test_data_pipeline_matches_reference():
    for hosts, host in ((1, 0), (2, 1)):
        want = JaxSyntheticTokens(512, 16, 4, seed=3, num_hosts=hosts, host_id=host)
        got = SyntheticTokens(512, 16, 4, seed=3, num_hosts=hosts, host_id=host)
        for step in (0, 5):
            w, g = want.batch_at(step), got.batch_at(step)
            assert w.keys() == g.keys()
            for k in w:
                assert np.array_equal(w[k], g[k]) and w[k].dtype == g[k].dtype
        assert host_shard_info(8, hosts, host) == jax_host_shard_info(8, hosts, host)
    it = Prefetcher(iter(SyntheticTokens(64, 8, 2)), depth=2)
    first = [next(it) for _ in range(3)]
    it.close()
    jit_ = JaxPrefetcher(iter(JaxSyntheticTokens(64, 8, 2)), depth=2)
    for g, w in zip(first, (next(jit_) for _ in range(3))):
        assert all(np.array_equal(g[k], w[k]) for k in w)
    jit_.close()


# ----------------------------------------------------------------- losses
@pytest.mark.parametrize("S,softcap", [(70, None), (64, 30.0)])
def test_chunked_xent_matches_jax(S, softcap):
    """Chunks of 32 with a padded last one (S = 70), ignored labels, and a
    final softcap: the loss and its gradients in x and the table."""
    jcfg = jax_smoke_config(ARCH).reduced(final_softcap=softcap)
    tcfg = get_smoke_config(ARCH).reduced(final_softcap=softcap)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, S, jcfg.d_model), dtype=np.float32)
    table = rng.standard_normal((jcfg.vocab_size, jcfg.d_model), dtype=np.float32) * 0.1
    labels = rng.integers(0, jcfg.vocab_size, (2, S))
    labels[0, :5] = -1

    def jloss(x, tok):
        return jax_layers.chunked_softmax_xent(x, {"tok": tok}, jnp.asarray(labels), jcfg,
                                               chunk=32)

    want, (jdx, jdt) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                                 jnp.asarray(table))
    tx, tt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(table).requires_grad_()
    got = layers.chunked_softmax_xent(tx, {"tok": tt}, torch.from_numpy(labels), tcfg, chunk=32)
    dx, dt = torch.autograd.grad(got, (tx, tt))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(dt.numpy(), np.asarray(jdt), rtol=1e-4, atol=1e-7)
    logits = x @ table.T
    if softcap:
        logits = softcap * np.tanh(logits / softcap)
    full = layers.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want_full = jax_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(full), float(want_full), rtol=1e-6)
    np.testing.assert_allclose(float(full), float(want), rtol=1e-5)


# ------------------------------------------------------------------ driver
def test_train_main_runs_on_cpu(capsys):
    ops.reset_launch_counts()
    losses = train.main(["--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert out.count("step ") == 3 and "done: first-loss" in out
    assert all(n == 0 for n in ops.launch_counts().values())  # plain versions only
    with pytest.raises(RuntimeError, match="injected failure at step 1"):
        train.main(["--smoke", "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
                    "--fail-at", "1"])


def test_train_main_requires_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--smoke", "--steps", "1"])
