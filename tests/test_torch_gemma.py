"""The port's gemma3-4b and gemma2-9b (sandwich norms, the sqrt(d) embedding
scale; gemma3's 5:1 window/global layers with qk-norm, gemma2's attention
softcap 50 and final softcap 30) against the JAX package on the CPU,
serving and training.

The JAX ``Model.init`` parameters, with every norm scale drawn at random
in place of init's ones (so that a sandwich norm applied to the wrong
tensor, or not at all, shows), are carried into the port with
``params_from_jax``; both sides get the same numpy prompts and batches:
prefill logits and every layer's cache with the prompt longer than the
smoke window of 16 (so the rings wrap), four greedy decode steps, the
loss and every gradient of the smoke configs as published (and at head
dim 256 with a softcap that bites).  In fp32
at 1e-5, as the other serving tests.  Also: the scaled embedding bit-equal
to the reference's in bf16 at the full widths, the full configs' shapes
against the reference's ``eval_shape``, the served caches' bytes, which
kernels a forward reaches, and the entry point with plans.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.convert import cache_from_jax, params_from_jax, unstack_program
from repro_torch.models.transformer import embed_scale, init_program_cache
from repro_torch.tree import map_tree, tree_leaves

ARCHS = ["gemma3-4b", "gemma2-9b"]


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _random_scales(params, seed: int):
    """``params`` with every norm scale (ln1, ln1_post, ln2, ln2_post, the
    final norm, q-norm and k-norm) drawn from 1 + N(0, 0.09) in place of
    init's ones.  A leaf of a scanned segment carries a leading [reps]
    axis."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        key = jax.tree_util.keystr(path)
        if key.endswith("['scale']") or key.endswith("_norm']"):
            return (1.0 + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        return np.asarray(a)

    return jax.tree_util.tree_map_with_path(draw, params)


def _models(arch: str, seed: int = 0, **change):
    jcfg = jax_smoke_config(arch).reduced(**change)
    tcfg = get_smoke_config(arch).reduced(**change)
    jmodel = jax_build_model(jcfg)
    jparams = _random_scales(jmodel.init(jax.random.PRNGKey(seed)), seed + 7)
    return jmodel, jparams, build_model(tcfg, "cpu"), tcfg


# ------------------------------------------------------------- the config
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch):
    for port, ref_cfg in ((get_config(arch), jax_config(arch)),
                          (get_smoke_config(arch), jax_smoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref_cfg)
    full = get_config(arch)
    assert (full.head_dim, full.sandwich_norms, full.scale_embed, full.tie_embeddings) == \
        (256, True, True, True)
    if arch == "gemma2-9b":
        assert (full.attn_softcap, full.final_softcap, full.attn_scale, full.rope_theta) == \
            (50.0, 30.0, 224.0**-0.5, 1e4)
    else:
        assert (full.qk_norm, full.rope_theta, full.attn_softcap) == (True, 1e6, None)


@pytest.mark.parametrize("arch,params,nbytes", [
    ("gemma3-4b", 3_880_099_328, 7_760_934_912),
    ("gemma2-9b", 9_241_705_984, 18_484_623_360),
])
def test_full_config_shapes_match_the_reference(arch, params, nbytes):
    """``Model.init_shapes()`` of the full config, on meta tensors, against
    the reference's ``eval_shape`` leaf for leaf (its stacked segments
    unstacked): every norm scale fp32, every matrix bf16, ``ln1_post`` and
    ``ln2_post`` in every layer."""
    from torch.utils._pytree import tree_flatten_with_path

    class Shape:  # a leaf whose [r] drops the stacked axis, as unstack_program reads it
        def __init__(self, shape):
            self.shape = tuple(shape)

        def __getitem__(self, r):
            return Shape(self.shape[1:])

    cfg = get_config(arch)
    jshapes = jax.tree.map(lambda a: Shape(a.shape),
                           jax_build_model(jax_config(arch)).init_shapes())
    jshapes = {"embed": jshapes["embed"], "final_norm": jshapes["final_norm"],
               "blocks": unstack_program(jshapes["blocks"], cfg.program)}
    tparams = build_model(cfg, "cpu").init_shapes()

    def paths(tree):
        leaves, _ = tree_flatten_with_path(tree, is_leaf=lambda a: isinstance(a, Shape))
        return {str(path): leaf for path, leaf in leaves}

    want = paths(jshapes)
    got = paths(map_tree(lambda t: Shape(t.shape), tparams))
    assert got.keys() == want.keys()
    assert all(got[k].shape == want[k].shape for k in want), \
        [k for k in want if got[k].shape != want[k].shape]
    leaves = paths(tparams)
    for key, t in leaves.items():
        assert t.dtype == (torch.float32 if t.ndim < 2 else torch.bfloat16), key
    for name in ("ln1_post", "ln2_post"):
        assert sum(f"'{name}'" in k for k in leaves) == cfg.num_layers
    assert sum(t.numel() for t in tree_leaves(tparams)) == params
    assert sum(t.numel() * t.element_size() for t in tree_leaves(tparams)) == nbytes


@pytest.mark.parametrize("arch,B,P,nbytes", [
    ("gemma3-4b", 4, 2048, 656_932_864),   # 29 rings of 1024 slots, 5 caches of 2080
    ("gemma2-9b", 4, 512, 748_683_264),    # 42 caches of 544 slots (the window is 4096)
])
def test_served_cache_bytes(arch, B, P, nbytes):
    """The cache ``chip_smoke.py`` serves (32 new tokens), on meta tensors:
    k and v [B, KV 4 or 8, slots, 256] bf16 a layer, a window layer's ring
    of min(max_seq, window) slots."""
    cfg = get_config(arch)
    cache = init_program_cache(cfg, cfg.program, B, P + 32, torch.bfloat16, "meta")
    assert sum(t.numel() * t.element_size() for t in tree_leaves(cache)) == nbytes


# ------------------------------------------------------- the pieces
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_sandwich_norms(arch):
    """Each layer's ``ln1_post`` and ``ln2_post`` scales (random here) reach
    the port unchanged, fp32, layer by layer in program order."""
    jmodel, jparams, _, tcfg = _models(arch)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    want = unstack_program(jax.tree.map(np.asarray, jparams["blocks"]), tcfg.program)
    assert len(tparams["blocks"]) == len(want) == tcfg.num_layers
    for got, ref_layer in zip(tparams["blocks"], want):
        for name in ("ln1_post", "ln2_post"):
            assert got[name]["scale"].dtype == torch.float32
            np.testing.assert_array_equal(got[name]["scale"].numpy(), ref_layer[name]["scale"])
    assert len({float(t["ln1_post"]["scale"][0]) for t in tparams["blocks"]}) == tcfg.num_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_embedding_scale_is_bit_equal_in_bf16(arch):
    """In bf16 at the full config's d_model (2560: sqrt 50.596 rounds to
    50.5; 3584: 59.867 to 59.75) the port's scaled embedding equals the
    reference's ``_embed_inputs`` bit for bit; multiplying by the unrounded
    root would not."""
    d = get_config(arch).d_model
    jcfg = jax_smoke_config(arch).reduced(d_model=d, dtype="bfloat16")
    tcfg = get_smoke_config(arch).reduced(d_model=d, dtype="bfloat16")
    rng = np.random.default_rng(5)
    table = rng.standard_normal((tcfg.vocab_size, d), dtype=np.float32)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 9))
    want, _ = jax_build_model(jcfg)._embed_inputs(
        {"embed": {"tok": jnp.asarray(table, jnp.bfloat16)}},
        {"tokens": jnp.asarray(tokens, jnp.int32)})
    want = np.asarray(want.astype(jnp.float32))
    tok = {"tok": torch.from_numpy(table).to(torch.bfloat16)}
    got = build_model(tcfg, "cpu")._embed({"embed": tok}, torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    assert embed_scale(tcfg) == {2560: 50.5, 3584: 59.75}[d]
    np.testing.assert_array_equal(got.float().numpy(), want)
    unrounded = (tok["tok"][torch.from_numpy(tokens)] * d**0.5).float().numpy()
    assert (unrounded != want).mean() > 0.1


# ------------------------------------------------------------ end to end
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_jax_model(arch):
    """Prefill of a B2 prompt of 20 tokens (past the smoke window of 16, so
    every window layer's ring wraps), then 4 greedy decode steps, in fp32:
    the logits after each within 1e-5, the greedy tokens equal, and every
    layer's cache after prefill and after the last step.  Both sides decode
    the reference's tokens."""
    tol = 1e-5
    jmodel, jparams, tmodel, tcfg = _models(arch)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    B, P, steps = 2, 20, 4
    max_seq = P + steps
    windows = {spec.window for unit, _ in tcfg.program for spec in unit if spec.window}
    assert windows == {16} and P > 16
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab_size, (B, P))
    jlogits, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, max_seq=max_seq))(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tlogits, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, max_seq)
    assert tlogits.shape == (B, 1, tcfg.vocab_size)

    def check_caches(when):
        jlayers = cache_from_jax(jcache, jmodel.cfg)
        assert len(jlayers) == len(tcache) == tcfg.num_layers
        for i, (jl, tl) in enumerate(zip(jlayers, tcache)):
            for name in ("k", "v"):
                assert tl["kv"][name].shape == jl["kv"][name].shape, (when, i, name)
                assert _rel(tl["kv"][name], jl["kv"][name]) < tol, (when, i, name)

    check_caches("prefill")
    jdecode = jax.jit(jmodel.decode_step)
    for i in range(steps):
        assert _rel(tlogits, jlogits) < tol, f"step {i}"
        jtok = np.array(jnp.argmax(jlogits[:, -1], axis=-1))[:, None]
        np.testing.assert_array_equal(tlogits[:, -1].argmax(-1, keepdim=True).numpy(), jtok)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(jtok, jnp.int32), jnp.int32(P + i))
        tlogits, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(jtok), P + i)
    assert _rel(tlogits, jlogits) < tol
    check_caches("decode")


# Training holds the smoke configs as published (windows of 16 at S 32, so
# the window layers mask; gemma2's attention softcap 50 and final softcap
# 30; the sandwich norms, the embedding scale, gemma3's qk-norm), through
# the flash gradient with the window and the softcap, and a second case at
# the full configs' head dim 256 with a softcap of 2 on both sides, where
# scores of a cap or more make the softcap's factor 1 - t^2 matter.  fp32
# masters on both sides, as tests/test_torch_train.py holds qwen3's loss
# and gradients.
TRAIN_CASES = {"published": {}, "hd256-softcap2": {"head_dim": 256, "attn_softcap": 2.0}}


@pytest.mark.parametrize("change", list(TRAIN_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, change):
    from repro.data import SyntheticTokens as JaxSyntheticTokens

    jmodel, jparams, tmodel, tcfg = _models(arch, seed=1, **TRAIN_CASES[change])
    assert tcfg.sandwich_norms and tcfg.scale_embed
    assert {spec.window for unit, _ in tcfg.program for spec in unit} == {16, None}
    batch = JaxSyntheticTokens(tcfg.vocab_size, 32, 2, seed=0).batch_at(0)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu", torch.float32)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    tloss, _ = tmodel.loss(tparams, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    grads = torch.autograd.grad(tloss, leaves)
    tloss = float(tloss.detach())
    assert abs(tloss - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg, "cpu",
                                       torch.float32))
    assert len(want) == len(grads)
    rel = [((g - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
           for g, w in zip(grads, want)]
    assert max(rel) < 1e-4, max(rel)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_trains_the_smoke_model(arch, capsys):
    """``train.main --arch <gemma> --smoke --device cpu --steps 2`` at the
    smoke windows' length past 16: finite losses, and no kernel launched
    (plain versions only)."""
    from repro_torch.launch import train

    ops.reset_launch_counts()
    losses = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "32", "--log-every", "1"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "done: first-loss" in capsys.readouterr().out
    assert not any(ops.launch_counts().values())


# ------------------------------------------------------ kernels, entry point
@pytest.mark.parametrize("arch,norms", [("gemma3-4b", 6), ("gemma2-9b", 4)])
def test_forward_reaches_flash_and_rmsnorm(arch, norms, monkeypatch):
    """A prefill reaches ``ops.flash_mha`` once a layer (causal, with the
    layer's window and the config's softcap and scale) and
    ``ops.fused_rmsnorm`` ``norms`` times a layer (ln1, ln1_post, ln2,
    ln2_post, and gemma3's q-norm and k-norm) plus the final norm; a decode
    step reaches the norms as often and flash never: the arithmetic of
    ``chip_smoke.py``'s launch counts."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    calls = {"norm": 0, "flash": []}
    real_norm, real_flash = ops.fused_rmsnorm, ops.flash_mha

    def norm(*args, **kwargs):
        calls["norm"] += 1
        return real_norm(*args, **kwargs)

    def flash(q, k, v, **kw):
        calls["flash"].append((kw["causal"], kw["window"], kw["softcap"], kw["scale"]))
        return real_flash(q, k, v, **kw)

    monkeypatch.setattr(ops, "fused_rmsnorm", norm)
    monkeypatch.setattr(ops, "flash_mha", flash)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 20)))
    _, cache = model.prefill(params, {"tokens": tokens}, max_seq=22)
    specs = [spec for unit, reps in cfg.program for _ in range(reps) for spec in unit]
    scale = cfg.attn_scale if cfg.attn_scale is not None else cfg.head_dim**-0.5
    assert calls["flash"] == [(True, spec.window, cfg.attn_softcap, scale) for spec in specs]
    assert calls["norm"] == norms * cfg.num_layers + 1
    calls.update(norm=0, flash=[])
    model.decode_step(params, cache, tokens[:, :1], 20)
    assert calls == {"norm": norms * cfg.num_layers + 1, "flash": []}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_smoke_with_and_without_plans(arch, tmp_path, capsys):
    """``serve.main --arch <gemma> --smoke --device cpu`` at a prompt past
    the window; with ``--plan --plan-cache`` both steps trace on fake
    tensors and solve, and a second run restores both plans; the greedy
    tokens are equal in all three."""
    def run(argv):
        ops.reset_launch_counts()
        gen = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "20", "--gen", "4"] + argv)
        assert not any(ops.launch_counts().values())
        return gen, capsys.readouterr().out

    cfg = get_smoke_config(arch)
    gen, _ = run([])
    assert gen.shape == (2, 4) and 0 <= int(gen.min()) and int(gen.max()) < cfg.vocab_size
    argv = ["--plan", "--plan-cache", str(tmp_path)]
    planned, out = run(argv)
    assert torch.equal(planned, gen)
    for role in ("prefill", "decode"):
        assert f"[plan] {role}: solved" in out, out
    again, out = run(argv)
    assert torch.equal(again, gen)
    for role in ("prefill", "decode"):
        assert f"[plan] {role}: restored from cache" in out, out
