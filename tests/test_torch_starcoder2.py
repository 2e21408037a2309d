"""The port's starcoder2-7b (LayerNorm with a bias, the GELU FFN with
biases, GQA groups of 9 at full width) against the JAX package on the CPU.

The JAX ``Model.init`` parameters, with every norm scale, norm bias and
FFN bias drawn at random in place of init's ones and zeros (so that one
applied to the wrong tensor shows), are carried into the port with
``params_from_jax``; both sides get the same numpy prompts and batches:
the layers one by one, prefill logits and every layer's cache, four
decode steps, the loss and every gradient.  Also: the full config's
shapes against the reference's ``eval_shape``, the entry point, and which
kernels a forward reaches (flash only: no RMSNorm runs for a LayerNorm).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.models import rope as jax_rope
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention, build_model, layers, rope
from repro_torch.models.convert import cache_from_jax, kv_from_jax, params_from_jax, \
    unstack_program
from repro_torch.tree import map_tree, tree_leaves

ARCH = "starcoder2-7b"


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _random_vectors(params, seed: int):
    """``params`` with every norm scale drawn from 1 + N(0, 0.09), and every
    norm bias and FFN bias from N(0, 0.09), in place of init's ones and
    zeros.  A leaf of a scanned segment carries a leading [reps] axis."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        key = jax.tree_util.keystr(path)
        if key.endswith("['scale']"):
            return (1.0 + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        if key.endswith("['bias']") or key.endswith("['b_up']") or key.endswith("['b_down']"):
            return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        return np.asarray(a)

    return jax.tree_util.tree_map_with_path(draw, params)


def _models(dtype: str, seed: int = 0):
    jcfg = jax_smoke_config(ARCH).reduced(dtype=dtype)
    tcfg = get_smoke_config(ARCH).reduced(dtype=dtype)
    jmodel = jax_build_model(jcfg)
    jparams = _random_vectors(jmodel.init(jax.random.PRNGKey(seed)), seed + 7)
    return jmodel, jparams, build_model(tcfg, "cpu"), tcfg


# ------------------------------------------------------------- the config
def test_config_matches_jax():
    for port, ref_cfg in ((get_config(ARCH), jax_config(ARCH)),
                          (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref_cfg)
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.head_dim,
            full.d_ff, full.vocab_size, full.norm_type, full.ffn_act, full.rope_theta,
            full.qk_norm, full.tie_embeddings) == \
        (32, 4608, 36, 4, 128, 18432, 49_152, "layer", "gelu", 1e5, False, True)


def test_full_config_shapes_match_the_reference():
    """``Model.init_shapes()`` of the full config, on meta tensors, against
    the reference's ``eval_shape`` leaf for leaf: every norm's scale and
    bias and every FFN bias fp32, every matrix bf16; 7,173,596,160
    parameters, 14,349,864,960 B as stored."""
    from torch.utils._pytree import tree_flatten_with_path

    class Shape:  # a leaf whose [r] drops the stacked axis, as unstack_program reads it
        def __init__(self, shape):
            self.shape = tuple(shape)

        def __getitem__(self, r):
            return Shape(self.shape[1:])

    cfg = get_config(ARCH)
    jshapes = jax.tree.map(lambda a: Shape(a.shape),
                           jax_build_model(jax_config(ARCH)).init_shapes())
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
        assert t.device.type == "meta", key
    assert sum("'bias'" in k for k in leaves) == 2 * 32 + 1
    assert sum(t.numel() for t in tree_leaves(tparams)) == 7_173_596_160
    assert sum(t.numel() * t.element_size() for t in tree_leaves(tparams)) == 14_349_864_960


# ------------------------------------------------------ module by module
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_layernorm_and_gelu_ffn_match_jax(dtype, tol):
    """ln1 (LayerNorm: fp32 inside, scale and bias) and the GELU FFN with
    its biases of layer 0, on random scales and biases."""
    jmodel, jparams, _, tcfg = _models(dtype)
    jcfg = jmodel.cfg
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["l0"])
    tp = tparams["blocks"][0]
    assert tp["ln1"]["bias"].dtype == tp["ffn"]["b_up"].dtype == torch.float32
    x = 3.0 * np.random.default_rng(1).standard_normal((2, 5, jcfg.d_model), dtype=np.float32)
    xj, xt = jnp.asarray(x, jcfg.dtype), torch.from_numpy(x).to(layers.dtype_of(tcfg))
    got = layers.apply_norm(tp["ln1"], xt, tcfg)
    assert got.dtype == xt.dtype
    assert _rel(got, jax_layers.apply_norm(jp["ln1"], xj, jcfg)) < tol
    assert _rel(layers.apply_dense_ffn(tp["ffn"], xt, tcfg),
                jax_layers.apply_dense_ffn(jp["ffn"], xj, jcfg)) < tol


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_gqa_group_of_three_attention_matches_jax(dtype, tol):
    """Prefill attention (the flash operator, causal, 6 query heads on 2 kv
    heads: groups of 3) and a decode step against the JAX module."""
    jmodel, jparams, _, tcfg = _models(dtype)
    jcfg = jmodel.cfg
    assert jcfg.num_heads // jcfg.num_kv_heads == 3
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    spec = jcfg.program[0][0][0]
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["l0"]["attn"])
    tp = tparams["blocks"][0]["attn"]
    S, max_seq = 11, 14
    x = np.random.default_rng(2).standard_normal((2, S, jcfg.d_model), dtype=np.float32)
    xj, xt = jnp.asarray(x, jcfg.dtype), torch.from_numpy(x).to(layers.dtype_of(tcfg))
    pos = np.broadcast_to(np.arange(S), (2, S))
    ja = jax_rope.rope_angles(jnp.asarray(pos), jcfg.head_dim, jcfg.rope_theta)
    ta = rope.rope_angles(torch.from_numpy(pos.copy()), tcfg.head_dim, tcfg.rope_theta)
    jout, jcache = jax_attention.prefill_attention(jp, xj, jcfg, spec, ja, max_seq)
    tout, tcache = attention.prefill_attention(tp, xt, tcfg, spec, ta, max_seq)
    assert _rel(tout, jout) < tol
    for name in ("k", "v"):
        assert _rel(tcache[name], kv_from_jax(jcache[name])) < tol
    x1 = x[:, :1] * 0.5
    a1 = np.full((2, 1), S)
    jout, jcache = jax_attention.decode_attention(
        jp, jnp.asarray(x1, jcfg.dtype), jcache, jnp.int32(S), jcfg, spec,
        jax_rope.rope_angles(jnp.asarray(a1), jcfg.head_dim, jcfg.rope_theta))
    tout, tcache = attention.decode_attention(
        tp, torch.from_numpy(x1).to(layers.dtype_of(tcfg)), tcache, torch.tensor(S), tcfg, spec,
        rope.rope_angles(torch.from_numpy(a1), tcfg.head_dim, tcfg.rope_theta))
    assert _rel(tout, jout) < tol
    for name in ("k", "v"):
        assert _rel(tcache[name], kv_from_jax(jcache[name])) < tol


# ------------------------------------------------------------ end to end
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_serving_matches_jax_model(dtype, tol):
    """Prefill of a B2 prompt of 12 tokens, then 4 decode steps: the logits
    after each, and every layer's cache after prefill and after the last
    step.  Both sides decode the reference's tokens, so a bf16 near-tie
    cannot fork the two sequences."""
    jmodel, jparams, tmodel, tcfg = _models(dtype)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    B, P, steps = 2, 12, 4
    max_seq = P + steps
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab_size, (B, P))
    jlogits, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, max_seq=max_seq))(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tlogits, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, max_seq)
    assert tlogits.shape == (B, 1, tcfg.vocab_size)

    def check_caches(when):
        jlayers = cache_from_jax(jcache, jmodel.cfg)
        assert len(jlayers) == len(tcache) == tcfg.num_layers
        for i, (jl, tl) in enumerate(zip(jlayers, tcache)):
            assert jl.keys() == tl.keys() == {"kv"}
            for name in ("k", "v"):
                assert _rel(tl["kv"][name], jl["kv"][name]) < tol, (when, i, name)

    check_caches("prefill")
    jdecode = jax.jit(jmodel.decode_step)
    for i in range(steps):
        assert _rel(tlogits, jlogits) < tol, f"step {i}"
        jtok = np.array(jnp.argmax(jlogits[:, -1], axis=-1))[:, None]
        if dtype == "float32":
            np.testing.assert_array_equal(tlogits[:, -1].argmax(-1, keepdim=True).numpy(), jtok)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(jtok, jnp.int32), jnp.int32(P + i))
        tlogits, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(jtok), P + i)
    assert _rel(tlogits, jlogits) < tol
    check_caches("decode")


# fp32 masters on both sides, as tests/test_torch_train.py holds qwen3's
# loss and gradients: the same arithmetic in another order.
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_grads_match_jax(remat):
    """``Model.loss`` and every gradient (LayerNorm scales and biases, the
    GELU FFN's weights and biases, attention through the causal flash
    gradient) against ``jax.value_and_grad`` of the reference's loss."""
    from repro.data import SyntheticTokens as JaxSyntheticTokens

    jmodel, jparams, tmodel, tcfg = _models("float32", seed=1)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu", torch.float32)
    batch = JaxSyntheticTokens(tcfg.vocab_size, 32, 2, seed=0).batch_at(0)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, remat=remat),
        has_aux=True)(jparams)
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    tloss, _ = tmodel.loss(tparams, {k: torch.from_numpy(v).long() for k, v in batch.items()},
                           remat=remat)
    grads = torch.autograd.grad(tloss, leaves)
    tloss = float(tloss.detach())
    assert abs(tloss - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg, "cpu",
                                       torch.float32))
    assert len(want) == len(grads)
    rel = [((g - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
           for g, w in zip(grads, want)]
    assert max(rel) < 1e-4, max(rel)


# ------------------------------------------------------ kernels, entry point
def test_forward_reaches_flash_and_no_rmsnorm(monkeypatch):
    """A prefill reaches ``ops.flash_mha`` once a layer (causal, no window)
    and never ``ops.fused_rmsnorm`` (its norms are LayerNorm, and it has no
    qk-norm); a decode step reaches neither."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    calls = {"norm": 0, "flash": []}
    real_flash = ops.flash_mha

    def norm(*args, **kwargs):
        calls["norm"] += 1
        raise AssertionError("an RMSNorm ran for a LayerNorm model")

    def flash(q, k, v, **kw):
        calls["flash"].append((kw["causal"], kw["window"], q.shape[1], k.shape[1]))
        return real_flash(q, k, v, **kw)

    monkeypatch.setattr(ops, "fused_rmsnorm", norm)
    monkeypatch.setattr(ops, "flash_mha", flash)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 10)))
    _, cache = model.prefill(params, {"tokens": tokens}, max_seq=12)
    assert calls["flash"] == [(True, None, 10, 10)] * cfg.num_layers
    calls["flash"] = []
    model.decode_step(params, cache, tokens[:, :1], 10)
    assert calls == {"norm": 0, "flash": []}


def test_gelu_is_the_tanh_form():
    """The FFN's GELU is ``jax.nn.gelu``'s default, the tanh form: at d_ff =
    d_model with identity matrices and zero biases the FFN is the
    activation itself, held to the reference's at 1e-6, which the erf form
    (``F.gelu``'s default, up to 4.7e-4 away near |x| = 2.7) misses."""
    cfg = get_smoke_config(ARCH).reduced(dtype="float32", d_ff=72)
    d = cfg.d_model
    eye = np.eye(d, dtype=np.float32)
    zeros = np.zeros(d, np.float32)
    jp = {"w_up": jnp.asarray(eye), "b_up": jnp.asarray(zeros), "w_down": jnp.asarray(eye),
          "b_down": jnp.asarray(zeros)}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.linspace(-4.0, 4.0, 4 * d, dtype=np.float32).reshape(4, d)
    want = np.asarray(jax_layers.apply_dense_ffn(jp, jnp.asarray(x), cfg))
    got = layers.apply_dense_ffn(tp, torch.from_numpy(x), cfg).numpy()
    assert np.abs(got - want).max() < 1e-6
    erf = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 4e-4


def test_serve_starcoder2_smoke_with_and_without_plans(tmp_path, capsys):
    """``serve.main --arch starcoder2-7b --smoke --device cpu``; with ``--plan
    --plan-cache`` both steps trace on fake tensors and solve, and a second
    run restores both plans; the greedy tokens are equal in all three."""
    def run(argv):
        ops.reset_launch_counts()
        gen = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "12", "--gen", "4"] + argv)
        assert not any(ops.launch_counts().values())
        return gen, capsys.readouterr().out

    cfg = get_smoke_config(ARCH)
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
