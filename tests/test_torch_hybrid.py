"""The port's hybrid slice (hymba: sliding-window attention with ring caches,
attention + Mamba-2 layers) against the JAX package on the CPU.

The JAX ``Model.init`` parameters are carried into the port with
``params_from_jax``; both sides get the same numpy prompts and are compared
end to end: prefill logits, every layer's ``kv`` ring and ``ssm`` cache
(through ``cache_from_jax``), and each decode step's logits, with the ring
wrapping during prefill in one case and during decode in another.  A
window-only program (qwen3's smoke widths with window and full layers) is
held to the JAX model built from the same config.  Also: the full config's
shapes against the reference's ``eval_shape``, its long_500k decode cell's
cache bytes, the SSD's routing at hymba's widths, and the entry point with
and without plans.  Training is ``tests/test_torch_hybrid_train.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import specs as jax_specs
from repro.configs.base import LayerSpec as JaxLayerSpec
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro.models import rope as jax_rope
from repro_torch.configs import get_config, get_smoke_config, specs
from repro_torch.configs.base import LayerSpec
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import variant as ssd_variant
from repro_torch.launch import serve
from repro_torch.models import attention, build_model, rope, ssm
from repro_torch.models.convert import cache_from_jax, kv_from_jax, params_from_jax, \
    unstack_program
from repro_torch.tree import map_tree, tree_leaves

ARCH = "hymba-1.5b"


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _round_matrices_to_bf16(params, program):
    """The values the port holds after ``params_from_jax`` in bf16 (matrices
    rounded to bf16, vectors fp32), as fp32, for the JAX model run in fp32.
    A segment repeated more than once carries the scan's leading [reps]
    axis on every leaf, so its matrices have one more dimension."""
    def rounded(min_ndim):
        return lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)
                                    if a.ndim >= min_ndim else a, np.float32)

    return {"embed": jax.tree.map(rounded(2), params["embed"]),
            "blocks": [jax.tree.map(rounded(3 if reps > 1 else 2), seg)
                       for (_, reps), seg in zip(program, params["blocks"])],
            "final_norm": jax.tree.map(rounded(2), params["final_norm"])}


def _random_norm_scales(params, seed: int):
    """``params`` with every norm scale (ln1, ln2, the branch norms, the gated
    norm, the final norm) drawn from 1 + N(0, 0.25) in place of init's ones,
    so that a scale applied to the wrong tensor shows."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if "norm" not in jax.tree_util.keystr(path):
            return a
        return (1.0 + 0.5 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def _serve_both(jcfg, tcfg, P: int, steps: int, tol: float, seed: int, bf16_vs_fp32=False):
    """Prefill a B2 prompt of ``P`` tokens and decode ``steps`` tokens on the
    JAX model and the port from the same parameters; hold the logits after
    every step and every layer's caches after prefill and after the last
    step to ``tol``, relative to max|want|.  Both sides decode the
    reference's tokens, so a near-tie cannot fork the sequences.  The norm
    scales are random (``_random_norm_scales``).  With
    ``bf16_vs_fp32`` the port runs ``tcfg`` in bf16 and the JAX model runs in
    fp32 on the same bf16-rounded parameters."""
    jmodel = jax_build_model(jcfg)
    jparams = _random_norm_scales(jmodel.init(jax.random.PRNGKey(0)), seed)
    tmodel = build_model(tcfg, "cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    if bf16_vs_fp32:
        jmodel = jax_build_model(jcfg.reduced(dtype="float32"))
        jparams = _round_matrices_to_bf16(jparams, jcfg.program)
    B, max_seq = 2, P + steps
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (B, P))
    jlogits, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, max_seq=max_seq))(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tlogits, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, max_seq)
    empty = tmodel.init_cache(B, max_seq)
    assert map_tree(lambda t: tuple(t.shape), empty) == \
        map_tree(lambda t: tuple(t.shape), tcache)

    def check_caches(when):
        jlayers = cache_from_jax(jcache, jcfg)
        assert len(jlayers) == len(tcache) == jcfg.num_layers
        for i, (jl, tl) in enumerate(zip(jlayers, tcache)):
            assert jl.keys() == tl.keys(), i
            for kind in jl:
                for name in jl[kind]:
                    err = _rel(tl[kind][name], jl[kind][name])
                    assert err < tol, (when, i, kind, name, err)

    check_caches("prefill")
    jdecode = jax.jit(jmodel.decode_step)
    for i in range(steps):
        assert _rel(tlogits, jlogits) < tol, f"step {i}: {_rel(tlogits, jlogits)}"
        jtok = np.array(jnp.argmax(jlogits[:, -1], axis=-1))[:, None]
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(jtok, jnp.int32), jnp.int32(P + i))
        tlogits, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(jtok), P + i)
    assert _rel(tlogits, jlogits) < tol, _rel(tlogits, jlogits)
    check_caches("decode")
    return tcache


# ------------------------------------------------------------- the config
def test_config_matches_jax():
    for port, ref_cfg in ((get_config(ARCH), jax_config(ARCH)),
                          (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref_cfg)
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.head_dim,
            full.d_ff, full.vocab_size, full.ssm_state, full.ssm_heads, full.ssm_headdim,
            full.ssm_chunk) == (32, 1600, 25, 5, 64, 5504, 32_001, 16, 50, 64, 64)
    windows = [spec.window for unit, reps in full.program for _ in range(reps) for spec in unit]
    assert [i for i, w in enumerate(windows) if w is None] == [0, 16, 31]
    assert set(windows) == {None, 1024}


def test_full_config_shapes_match_the_reference():
    """``Model.init_shapes()`` of the full config, on meta tensors, against the
    reference's ``eval_shape`` leaf for leaf (its stacked segments
    unstacked): the branch norms and every other vector fp32, every matrix
    bf16; 1,589,773,120 parameters, 3,180,380,288 B as stored."""
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
    branch = [k for k in leaves if "branch_norm" in k]
    assert len(branch) == 2 * 32 and all(leaves[k].shape == (1600,) for k in branch)
    assert sum(t.numel() for t in tree_leaves(tparams)) == 1_589_773_120
    assert sum(t.numel() * t.element_size() for t in tree_leaves(tparams)) == 3_180_380_288


def test_long_500k_cell_specs_and_cache_bytes():
    """The long_500k decode cell: the step's stand-ins are the reference's, and
    its cache holds full caches in the 3 global layers (2,013,265,920 B),
    rings of 1024 in the 29 window layers (38,010,880 B; full caches there
    would hold 19,461,570,560 B), the SSM states (6,553,600 B) and the conv
    tails (620,544 B)."""
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    assert specs.supports_shape(cfg, "long_500k") and jax_specs.supports_shape(jcfg, "long_500k")
    got, want = specs.input_specs(cfg, "long_500k"), jax_specs.input_specs(jcfg, "long_500k")
    assert tuple(got["tokens"].shape) == want["tokens"].shape == (1, 1)
    assert (tuple(got["pos"].shape), got["pos"].device.type) == (want["pos"].shape, "meta")
    cache = specs.cache_specs(build_model(cfg, "cpu"), cfg, "long_500k")
    by_kind = {"global": 0, "ring": 0, "state": 0, "conv": 0}
    for layer in cache:
        assert layer.keys() == {"kv", "ssm"}
        kv = sum(t.numel() * t.element_size() for t in layer["kv"].values())
        by_kind["global" if layer["kv"]["k"].shape[2] == 524_288 else "ring"] += kv
        assert layer["kv"]["k"].shape[2] in (524_288, 1024)
        for name in ("state", "conv"):
            t = layer["ssm"][name]
            by_kind[name] += t.numel() * t.element_size()
    assert by_kind == {"global": 2_013_265_920, "ring": 38_010_880, "state": 6_553_600,
                       "conv": 620_544}


# ------------------------------------------------------- ring attention
@pytest.mark.parametrize("P", [3, 8, 13], ids=["short", "full-ring", "wrapped"])
def test_window_decode_attention_matches_jax_across_the_wrap(P):
    """A window-8 layer: prefill of P positions (the ring filled in part,
    exactly, or wrapped), then decode steps up to position 20, each
    against the JAX module's step: output and ring.  The port's mask
    ``arange(W) <= pos`` is the reference's ``written_at >= 0``."""
    jcfg = jax_smoke_config("qwen3-4b")
    tcfg = get_smoke_config("qwen3-4b")
    jspec, tspec = JaxLayerSpec(attn="window", window=8), LayerSpec(attn="window", window=8)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["l0"]["attn"])
    tp = map_tree(lambda a: torch.from_numpy(np.array(a)), jp)
    max_seq, last = 32, 20
    assert attention.cache_len(tcfg, tspec, max_seq) == 8
    x = np.random.default_rng(11).standard_normal((2, last + 1, jcfg.d_model), dtype=np.float32)

    def angles(pos, hd=jcfg.head_dim):
        pos = np.broadcast_to(pos, (2, len(pos)))
        return (jax_rope.rope_angles(jnp.asarray(pos), hd, jcfg.rope_theta),
                rope.rope_angles(torch.from_numpy(pos.copy()), hd, tcfg.rope_theta))

    ja, ta = angles(np.arange(P))
    jout, jcache = jax_attention.prefill_attention(jp, jnp.asarray(x[:, :P]), jcfg, jspec, ja,
                                                   max_seq)
    tout, tcache = attention.prefill_attention(tp, torch.from_numpy(x[:, :P]), tcfg, tspec, ta,
                                               max_seq)
    assert _rel(tout, jout) < 1e-5
    for pos in range(P, last + 1):
        for name in ("k", "v"):
            assert _rel(tcache[name], kv_from_jax(jcache[name])) < 1e-5, (pos, name)
        ja, ta = angles(np.array([pos]))
        jout, jcache = jax_attention.decode_attention(
            jp, jnp.asarray(x[:, pos:pos + 1]), jcache, jnp.int32(pos), jcfg, jspec, ja)
        tout, tcache = attention.decode_attention(
            tp, torch.from_numpy(x[:, pos:pos + 1]), tcache, torch.tensor(pos), tcfg, tspec, ta)
        assert _rel(tout, jout) < 1e-5, pos
    for name in ("k", "v"):
        assert _rel(tcache[name], kv_from_jax(jcache[name])) < 1e-5, name


# ------------------------------------------------------------ end to end
@pytest.mark.parametrize("P", [5, 8, 13], ids=["shorter", "equal", "longer"])
def test_window_program_matches_jax_model(P):
    """qwen3's smoke widths with (window 8, full) layers, twice, against the
    JAX model of the same config: a prompt shorter than, equal to and longer
    than the window, then 6 decode steps past it, fp32 at 1e-5."""
    def program(cls):
        return (((cls(attn="window", window=8), cls(attn="full")), 2),)

    jcfg = jax_smoke_config("qwen3-4b").reduced(num_layers=4, program=program(JaxLayerSpec))
    tcfg = get_smoke_config("qwen3-4b").reduced(num_layers=4, program=program(LayerSpec))
    cache = _serve_both(jcfg, tcfg, P, 6, 1e-5, seed=12)
    assert [c["kv"]["k"].shape[2] for c in cache] == [8, P + 6] * 2


# bf16 against the JAX fp32 model on the same bf16-rounded parameters: the
# reference's bf16 model takes the SSD's cumsum and decays in bf16
# (tests/test_torch_ssm.py: test_bf16_ssd_stays_near_the_exact_recurrence),
# where the port follows the Pallas kernel, fp32 inside, so the port's bf16
# run is held to the function the JAX model computes in fp32.  What is left
# is the port's rounding of activations (and of the SSD's dt and A) to bf16
# between ops, through 4 layers of two branches each.  Measured on the CPU
# over prompts 12, 24 and 40 and three token seeds: logits 1.4e-2 to
# 3.2e-2, kv 1.3e-2 to 2.3e-2, ssm state 2.0e-2 to 3.9e-2, conv 1.6e-2 to
# 2.1e-2 (relative to max|want|); the same runs in fp16, 3 more mantissa
# bits, give 8 to 10 times less (at most 8.5e-3), so the gap is rounding.
# 5e-2, as tests/test_torch_ssm.py holds mamba2's bf16 run; a wrong ring
# slot, mask, decay or branch norm moves these by O(1).
BF16_VS_FP32_TOL = 5e-2


@pytest.mark.parametrize(
    "dtype,P,steps,tol",
    [("float32", 24, 4, 1e-5), ("float32", 12, 8, 1e-5),
     ("bfloat16", 24, 4, BF16_VS_FP32_TOL)],
    ids=["fp32-wrap-in-prefill", "fp32-wrap-in-decode", "bf16-vs-fp32"],
)
def test_hymba_smoke_serving_matches_jax_model(dtype, P, steps, tol):
    """hymba's smoke config (global, window 16, window 16, global; SSD chunk
    16): the ring wraps during prefill (prompt 24, which the SSD also pads)
    or during decode (prompt 12, positions 12 to 19); logits and every
    layer's ``kv`` and ``ssm`` caches against the JAX model."""
    jcfg = jax_smoke_config(ARCH).reduced(dtype=dtype)
    tcfg = get_smoke_config(ARCH).reduced(dtype=dtype)
    cache = _serve_both(jcfg, tcfg, P, steps, tol, seed=13, bf16_vs_fp32=dtype == "bfloat16")
    assert [c["kv"]["k"].shape[2] for c in cache] == [P + steps, 16, 16, P + steps]
    assert all(c["ssm"]["state"].dtype == torch.float32 for c in cache)


def test_hymba_branch_norms_and_kernel_entry_points(monkeypatch):
    """Every RMSNorm of a hybrid forward reaches ``ops.fused_rmsnorm`` (ln1,
    the two branch norms, the gated norm, ln2; then the final norm), prefill
    attention reaches ``ops.flash_mha`` with the layer's window, and the
    SSD ``ops.ssd``; decode runs the same norms and neither kernel."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    assert all(p["branch_norm_a"].dtype == p["branch_norm_m"].dtype == torch.float32
               for p in params["blocks"])
    calls = {"norm": [], "flash": [], "ssd": 0}
    real_norm, real_flash, real_ssd = ops.fused_rmsnorm, ops.flash_mha, ops.ssd

    def norm(x, scale, *, eps=1e-6):
        calls["norm"].append(x.shape[-1])
        return real_norm(x, scale, eps=eps)

    def flash(q, k, v, **kw):
        calls["flash"].append(kw["window"])
        return real_flash(q, k, v, **kw)

    def ssd(*args):
        calls["ssd"] += 1
        return real_ssd(*args)

    monkeypatch.setattr(ops, "fused_rmsnorm", norm)
    monkeypatch.setattr(ops, "flash_mha", flash)
    monkeypatch.setattr(ops, "ssd", ssd)
    d, di = cfg.d_model, cfg.d_inner
    per_forward = [d, d, d, di, d] * cfg.num_layers + [d]  # ln1, a, m's gated norm, ...
    tokens = torch.from_numpy(np.random.default_rng(14).integers(0, cfg.vocab_size, (1, 20)))
    _, cache = model.prefill(params, {"tokens": tokens}, max_seq=24)
    assert sorted(calls["norm"]) == sorted(per_forward)
    assert calls["flash"] == [None, 16, 16, None] and calls["ssd"] == cfg.num_layers
    calls.update(norm=[], flash=[], ssd=0)
    model.decode_step(params, cache, tokens[:, :1], 20)
    assert sorted(calls["norm"]) == sorted(per_forward)
    assert calls["flash"] == [] and calls["ssd"] == 0


@pytest.mark.parametrize("S", [100, 128], ids=["padded", "chunk-multiple"])
def test_ssd_routes_to_tc_at_hymba_widths(S, monkeypatch):
    """At hymba's widths in bf16 (conv_dim 3232: x [.., 50, 64], B and C
    [.., 1, 16]) the views of the conv output that ``apply_mamba`` hands
    the SSD, and the copies its pad makes when S is not a multiple of 64,
    are what the ``tc`` kernel takes (16-byte aligned, batch and sequence
    strides multiples of 8 elements)."""
    cfg = get_config(ARCH)
    p = ssm.init_mamba(torch.Generator("cpu").manual_seed(0), cfg)
    seen = []
    real = ops.ssd

    def spy(x, dt, A, Bm, Cm):
        seen.append((ssd_variant(x, Bm, Cm), tuple(x.shape), tuple(Bm.shape), x.stride(1)))
        return real(x, dt, A, Bm, Cm)

    monkeypatch.setattr(ops, "ssd", spy)
    x = torch.randn((1, S, cfg.d_model), generator=torch.Generator().manual_seed(1))
    ssm.apply_mamba(p, x.bfloat16(), cfg)
    padded = -(-S // cfg.ssm_chunk) * cfg.ssm_chunk
    stride = 50 * 64 if S % cfg.ssm_chunk else 3232  # the pad copies; else views of xBC
    assert seen == [("tc", (1, padded, 50, 64), (1, padded, 1, 16), stride)]


# ------------------------------------------------------- entry point, guards
def _serve(argv, capsys):
    ops.reset_launch_counts()
    gen = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "20", "--gen", "4"] + argv)
    assert not any(ops.launch_counts().values())
    return gen, capsys.readouterr().out


def test_serve_hymba_smoke_with_and_without_plans(tmp_path, capsys):
    """``serve.main --arch hymba-1.5b --smoke --device cpu`` (prompt 20, past
    the window of 16); with ``--plan --plan-cache`` the prefill and decode
    steps (rings, both branches) trace on fake tensors and solve, and a
    second run restores both plans; the greedy tokens are equal in all
    three runs."""
    cfg = get_smoke_config(ARCH)
    gen, _ = _serve([], capsys)
    assert gen.shape == (2, 4) and 0 <= int(gen.min()) and int(gen.max()) < cfg.vocab_size
    argv = ["--plan", "--plan-cache", str(tmp_path)]
    planned, out = _serve(argv, capsys)
    assert torch.equal(planned, gen)
    for role in ("prefill", "decode"):
        assert f"[plan] {role}: solved" in out, out
    again, out = _serve(argv, capsys)
    assert torch.equal(again, gen)
    for role in ("prefill", "decode"):
        assert f"[plan] {role}: restored from cache" in out, out
    assert len(list(tmp_path.glob("*.json"))) == 2
