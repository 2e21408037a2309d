"""The port's qwen2-vl-7b (M-RoPE with sections (16, 24, 24) over the t/h/w
channels of [3, B, S] positions; the vision stub's patch embeddings before
the text; an untied head) against the JAX package on the CPU.

The JAX ``Model.init`` parameters, with every norm scale drawn at random in
place of init's ones, are carried into the port with ``params_from_jax``;
both sides get the same numpy batches: patches drawn standard normal, and
positions whose channels differ (patch i at (t, h, w) = (0, i // 4, i % 4),
text token j at its own index in all three channels, so that decode
continues at S + i, its cache slot).  With the reference's arange in every
channel M-RoPE is plain RoPE, and a section taken from the wrong channel
could not show.  In fp32 at 1e-5, as the other serving tests; in bf16
against the JAX model in fp32 on the same bf16-rounded weights at 5e-2, as
tests/test_torch_hybrid.py and tests/test_torch_encdec.py hold theirs.
Also: the full config's shapes against the reference's ``eval_shape``,
the served cache's bytes, the cells' input specs, which kernels a forward
reaches, the serve and train entry points, and
``examples/serve_batched_torch.py``.
"""

import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import specs as jax_specs
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.launch import train as jax_train
from repro.models import build_model as jax_build_model
from repro.models import rope as jax_rope
from repro_torch.configs import get_config, get_smoke_config, specs
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.launch.steps import build_train_step
from repro_torch.models import build_model, rope
from repro_torch.models.convert import cache_from_jax, params_from_jax, unstack_program
from repro_torch.models.transformer import init_program_cache
from repro_torch.optim import adamw_init
from repro_torch.tree import map_tree, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-vl-7b"
NPATCH = 8  # serve's min(num_patch_tokens, 8), the smoke config's num_patch_tokens
FP32_TOL = 1e-5
# The port in bf16 against the JAX model in fp32 on the same bf16-rounded
# weights: what is left is the port's rounding of activations (and of the
# patches) to bf16 between ops.
BF16_VS_FP32_TOL = 5e-2


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _random_scales(params, seed: int):
    """``params`` with every norm scale (ln1, ln2, the final norm) drawn from
    1 + N(0, 0.09) in place of init's ones."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return (1.0 + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        return np.asarray(a)

    return jax.tree_util.tree_map_with_path(draw, params)


def _round_matrices_to_bf16(params):
    """The values the port holds after ``params_from_jax`` in bf16 (matrices
    rounded to bf16, vectors fp32), as fp32.  The blocks are one scanned
    segment, so their leaves carry the [reps] axis: a matrix there has three
    dimensions."""
    def rounded(min_ndim):
        return lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)
                                    if a.ndim >= min_ndim else a, np.float32)

    return {name: jax.tree.map(rounded(3 if name == "blocks" else 2), tree)
            for name, tree in params.items()}


def _models(dtype: str = "float32", seed: int = 0):
    jcfg = jax_smoke_config(ARCH).reduced(dtype=dtype)
    tcfg = get_smoke_config(ARCH).reduced(dtype=dtype)
    jmodel = jax_build_model(jcfg)
    jparams = _random_scales(jmodel.init(jax.random.PRNGKey(seed)), seed + 7)
    return jmodel, jparams, build_model(tcfg, "cpu"), tcfg


def _grid_positions(B: int, P: int) -> np.ndarray:
    """[3, B, NPATCH + P]: patch i at (t, h, w) = (0, i // 4, i % 4) on a
    2 x 4 grid, text token j at NPATCH + j in all three channels."""
    i = np.arange(NPATCH)
    pos = np.concatenate([np.stack([0 * i, i // 4, i % 4]),
                          np.broadcast_to(np.arange(NPATCH, NPATCH + P), (3, P))], axis=1)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, B, NPATCH + P)))


def _vision_inputs(cfg, B: int, P: int, seed: int) -> dict:
    """The patches, standard normal, and the grid positions, as numpy."""
    rng = np.random.default_rng(seed)
    return {"patch_embeds": rng.standard_normal((B, NPATCH, cfg.d_model), dtype=np.float32),
            "positions": _grid_positions(B, P)}


def _jb(batch: dict) -> dict:
    return {k: jnp.asarray(v, jnp.float32 if k == "patch_embeds" else jnp.int32)
            for k, v in batch.items()}


def _tb(batch: dict) -> dict:
    return {k: torch.from_numpy(v) if k == "patch_embeds" else torch.from_numpy(v).long()
            for k, v in batch.items()}


# ------------------------------------------------------------- the config
def test_config_matches_jax():
    for port, ref_cfg in ((get_config(ARCH), jax_config(ARCH)),
                          (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref_cfg)


def test_full_config_shapes_match_the_reference():
    """``Model.init_shapes()`` of the full config, on meta tensors, against
    the reference's ``eval_shape`` leaf for leaf (its stacked segment
    unstacked): norm scales fp32, matrices bf16, the untied ``head``;
    7,615,487,488 parameters, 15,231,383,552 B as stored."""
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
    for key, t in paths(tparams).items():
        assert t.dtype == (torch.float32 if t.ndim < 2 else torch.bfloat16), key
    assert tuple(tparams["embed"]["head"].shape) == (152_064, 3584)
    assert sum(t.numel() for t in tree_leaves(tparams)) == 7_615_487_488
    assert sum(t.numel() * t.element_size() for t in tree_leaves(tparams)) == 15_231_383_552


def test_served_cache_bytes():
    """The cache ``chip_smoke.py`` serves (B4, prompt 512, 32 new tokens):
    ``serve_lengths`` gives the reference's max_seq, 512 + 32 + 1024 = 1568
    slots, and the first decode position 520; k and v [4, 4, 1568, 128]
    bf16 in each of the 28 layers, 359,661,568 B."""
    cfg = get_config(ARCH)
    assert serve.serve_lengths(cfg, 512, 32) == (1568, 520)
    cache = init_program_cache(cfg, cfg.program, 4, 1568, torch.bfloat16, "meta")
    assert sum(t.numel() * t.element_size() for t in tree_leaves(cache)) == 359_661_568


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_input_specs_match_the_reference(shape):
    """A cell's step inputs against the reference's: a train cell's text
    tokens and labels, 1024 patches in the activation dtype and [3, B, S]
    positions (int64 in the port, int32 in the reference; the prefill
    cell's in tests/test_torch_encdec.py); a decode cell's token and
    position, and its cache."""
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    got, want = specs.input_specs(cfg, shape), jax_specs.input_specs(jcfg, shape)
    flat = got.get("batch", got)
    jflat = want.get("batch", want)
    assert {k: tuple(t.shape) for k, t in flat.items()} == \
        {k: tuple(t.shape) for k, t in jflat.items()}
    for k, t in flat.items():
        assert t.device.type == "meta"
        assert t.dtype == (torch.bfloat16 if k == "patch_embeds" else torch.long), k
    if shape == "decode_32k":
        # the smoke model's cache: k and v head-major [B, KV, S, hd] a layer,
        # as many elements as the reference's position-major stacked leaves
        smoke, jsmoke = get_smoke_config(ARCH), jax_smoke_config(ARCH)
        cache = specs.cache_specs(build_model(smoke, "cpu"), smoke, shape)
        jcache = jax_specs.cache_specs(jax_build_model(jsmoke), jsmoke, shape)
        sp = specs.SHAPES[shape]
        assert len(cache) == smoke.num_layers
        assert all(tuple(t.shape) == (sp.global_batch, smoke.num_kv_heads, sp.seq_len,
                                      smoke.head_dim) and t.device.type == "meta"
                   for layer in cache for t in layer["kv"].values())
        assert sum(t.numel() for t in tree_leaves(cache)) == \
            sum(math.prod(a.shape) for a in jax.tree.leaves(jcache))


# --------------------------------------------------------------- M-RoPE
@pytest.mark.parametrize("sections,head_dim", [((2, 3, 3), 16), ((16, 24, 24), 128)],
                         ids=["smoke", "full"])
def test_mrope_angles_match_jax(sections, head_dim):
    """``mrope_angles`` at random [3, B, S] positions against the
    reference's, and the rotation applied with them."""
    rng = np.random.default_rng(sum(sections))
    pos = rng.integers(0, 5000, (3, 2, 9))
    want = jax_rope.mrope_angles(jnp.asarray(pos, jnp.int32), head_dim, 1e6, sections)
    got = rope.mrope_angles(torch.from_numpy(pos), head_dim, 1e6, sections)
    assert got.shape == (2, 9, head_dim // 2) and got.dtype == torch.float32
    assert _rel(got, want) < 1e-6
    x = rng.standard_normal((2, 9, 4, head_dim), dtype=np.float32)
    assert _rel(rope.apply_rope(torch.from_numpy(x), got),
                jax_rope.apply_rope(jnp.asarray(x), want)) < 1e-5


def test_mrope_is_rope_only_where_the_channels_agree():
    """With one position in all three channels M-RoPE is RoPE bit for bit;
    with channels that differ, each section follows its own channel and
    differs from RoPE of the first."""
    sections, hd = (16, 24, 24), 128
    pos = torch.from_numpy(np.random.default_rng(2).integers(0, 2000, (2, 11)))
    plain = rope.rope_angles(pos, hd, 1e6)
    assert torch.equal(rope.mrope_angles(pos.expand(3, 2, 11), hd, 1e6, sections), plain)
    grid = torch.stack([pos, pos // 4, pos % 4])
    got = rope.mrope_angles(grid, hd, 1e6, sections)
    assert not torch.equal(got, plain)
    bounds = np.cumsum((0,) + sections)
    for ch in range(3):
        lo, hi = bounds[ch], bounds[ch + 1]
        assert torch.equal(got[..., lo:hi], rope.rope_angles(grid[ch], hd, 1e6)[..., lo:hi])
    assert not torch.equal(got[..., 16:], plain[..., 16:])


# ------------------------------------------------------------ end to end
@pytest.mark.parametrize("dtype,tol", [("float32", FP32_TOL), ("bfloat16", BF16_VS_FP32_TOL)],
                         ids=["fp32", "bf16-vs-fp32"])
def test_serving_matches_jax_model(dtype, tol):
    """Prefill of a B2 batch of 8 patches and a prompt of 20 tokens at the
    grid positions, then 4 greedy decode steps at S + i: the logits after
    each, and every layer's cache after prefill and after the last step.
    Both sides decode the reference's tokens; in fp32 the port's greedy
    tokens must equal them.  In bf16 the JAX model runs in fp32 on the
    bf16-rounded weights."""
    jmodel, jparams, tmodel, tcfg = _models(dtype, seed=1)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    if dtype == "bfloat16":
        jmodel = jax_build_model(jmodel.cfg.reduced(dtype="float32"))
        jparams = _round_matrices_to_bf16(jparams)
    B, P, steps = 2, 20, 4
    S = NPATCH + P
    max_seq = S + steps
    batch = dict(_vision_inputs(tcfg, B, P, 5),
                 tokens=np.random.default_rng(6).integers(0, tcfg.vocab_size, (B, P)))
    jlogits, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, max_seq=max_seq))(
        jparams, _jb(batch))
    tlogits, tcache = tmodel.prefill(tparams, _tb(batch), max_seq)
    assert tlogits.shape == (B, 1, tcfg.vocab_size)
    assert map_tree(lambda t: (tuple(t.shape), t.dtype), tmodel.init_cache(B, max_seq)) == \
        map_tree(lambda t: (tuple(t.shape), t.dtype), tcache)

    def check_caches(when):
        jlayers = cache_from_jax(jcache, jmodel.cfg)
        assert len(jlayers) == len(tcache) == tcfg.num_layers
        for i, (jl, tl) in enumerate(zip(jlayers, tcache)):
            for name in ("k", "v"):
                err = _rel(tl["kv"][name], jl["kv"][name])
                assert err < tol, (when, i, name, err)

    check_caches("prefill")
    jdecode = jax.jit(jmodel.decode_step)
    for i in range(steps):
        assert _rel(tlogits, jlogits) < tol, f"step {i}: {_rel(tlogits, jlogits)}"
        jtok = np.array(jnp.argmax(jlogits[:, -1], axis=-1))[:, None]
        if dtype == "float32":
            np.testing.assert_array_equal(tlogits[:, -1].argmax(-1, keepdim=True).numpy(), jtok)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(jtok, jnp.int32), jnp.int32(S + i))
        tlogits, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(jtok),
                                             torch.tensor(S + i))
    assert _rel(tlogits, jlogits) < tol, _rel(tlogits, jlogits)
    check_caches("decode")


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "plain"])
def test_loss_and_grads_match_jax(remat):
    """The loss of a B2 S32 ``SyntheticTokens`` batch after 8 patches at the
    grid positions, the labels padded with -1 over the patches, and every
    gradient (the patches' too) against ``jax.value_and_grad`` of the
    reference's loss, fp32 masters on both sides."""
    jmodel, jparams, tmodel, tcfg = _models(seed=2)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu", torch.float32)
    batch = dict(JaxSyntheticTokens(tcfg.vocab_size, 32, 2, seed=0).batch_at(0),
                 **_vision_inputs(tcfg, 2, 32, 9))

    def jloss_fn(p, patches):
        return jmodel.loss(p, dict(_jb(batch), patch_embeds=patches), remat=remat)[0]

    jloss, (jgrads, jgpatch) = jax.value_and_grad(jloss_fn, argnums=(0, 1))(
        jparams, jnp.asarray(batch["patch_embeds"]))
    leaves = tree_leaves(tparams)
    tbatch = _tb(batch)
    patches = tbatch["patch_embeds"].requires_grad_(True)
    for t in leaves:
        t.requires_grad_(True)
    tloss, metrics = tmodel.loss(tparams, tbatch, remat=remat)
    grads = torch.autograd.grad(tloss, leaves + [patches])
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert float(metrics["ce"]) == float(tloss.detach())
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg, "cpu",
                                       torch.float32))
    assert len(want) + 1 == len(grads)
    rel = [((g - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
           for g, w in zip(grads, want + [torch.from_numpy(np.array(jgpatch))])]
    assert max(rel) < 1e-4, max(rel)


def test_loss_scores_the_padded_labels():
    """The labels padded with -1 over the patches leave all but the last
    patch's position unscored: position i is scored against padded label
    i + 1 (the reference's shift), so the last patch's position against
    the first label and each text position but the last against the next
    label.  The loss equals that mean, computed here from the logits of a
    forward."""
    from repro_torch.models.layers import apply_norm, lm_logits
    from repro_torch.models.transformer import train_layer

    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(3))
    B, P = 2, 12
    batch = _tb(dict(_vision_inputs(cfg, B, P, 4),
                     tokens=np.random.default_rng(5).integers(0, cfg.vocab_size, (B, P)),
                     labels=np.random.default_rng(6).integers(0, cfg.vocab_size, (B, P))))
    loss, _ = model.loss(params, batch, remat=False)
    x, positions = model._embed_inputs(params, batch)
    angles = model._angles(positions)
    for p, spec in zip(params["blocks"], [s for u, r in cfg.program for _ in range(r) for s in u]):
        x, _ = train_layer(p, x, cfg, spec, angles)
    logits = lm_logits(params["embed"], apply_norm(params["final_norm"], x, cfg), cfg).float()
    # padded label NPATCH + j is labels[j], scored at position NPATCH + j - 1
    scored = logits[:, NPATCH - 1:-1]
    want = torch.nn.functional.cross_entropy(scored.reshape(-1, cfg.vocab_size),
                                             batch["labels"].reshape(-1))
    assert abs(float(loss) - float(want)) <= 1e-5 * float(want)


def test_accumulated_steps_cut_positions_along_the_batch():
    """``build_train_step`` with 2 micro-batches cuts the [3, B, S] positions
    along B (axis 1) as it cuts the tokens and patches: the loss and the
    gradient norm equal one step over the whole batch."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, "cpu")
    batch = _tb(dict(JaxSyntheticTokens(cfg.vocab_size, 16, 4, seed=1).batch_at(0),
                     **_vision_inputs(cfg, 4, 16, 2)))
    batch["positions"][:, 2:] += 3  # rows that differ, so a cut along the channels shows
    out = []
    for accum in (1, 2):
        params = model.init(torch.Generator().manual_seed(0), dtype=torch.float32)
        step = build_train_step(model, cfg, accum_steps=accum)
        _, _, m = step(params, adamw_init(params), batch, 0)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    (l1, n1), (l2, n2) = out
    assert abs(l1 - l2) <= 1e-6 * l1 and abs(n1 - n2) <= 1e-5 * n1, out


# ------------------------------------------------------ kernels, tracing
def test_forward_reaches_flash_and_rmsnorm(monkeypatch):
    """A prefill reaches ``ops.flash_mha`` once a layer over the patches and
    the prompt (causal, no window, no softcap) and ``ops.fused_rmsnorm``
    twice a layer (ln1, ln2; no qk-norm) plus the final norm; a decode step
    reaches the norms as often and flash never: the arithmetic of
    ``chip_smoke.py``'s launch counts, (2 x 28 + 1) x 32 = 1,824 RMSNorm and
    28 flash launches for the full model's serve of 32 tokens."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    calls = {"norm": 0, "flash": []}
    real_norm, real_flash = ops.fused_rmsnorm, ops.flash_mha

    def norm(*args, **kwargs):
        calls["norm"] += 1
        return real_norm(*args, **kwargs)

    def flash(q, k, v, **kw):
        calls["flash"].append((q.shape[1], kw["causal"], kw["window"], kw["softcap"]))
        return real_flash(q, k, v, **kw)

    monkeypatch.setattr(ops, "fused_rmsnorm", norm)
    monkeypatch.setattr(ops, "flash_mha", flash)
    batch = serve.serve_batch(cfg, 2, 20, 0, "cpu")
    _, cache = model.prefill(params, batch, max_seq=30)
    assert calls["flash"] == [(NPATCH + 20, True, None, None)] * cfg.num_layers
    assert calls["norm"] == 2 * cfg.num_layers + 1
    calls.update(norm=0, flash=[])
    model.decode_step(params, cache, batch["tokens"][:, :1], NPATCH + 20)
    assert calls == {"norm": 2 * cfg.num_layers + 1, "flash": []}


# ---------------------------------------------------------- entry points
def test_serve_smoke_with_plans_restores_them(tmp_path, capsys):
    """``serve.main --arch qwen2-vl-7b --smoke --device cpu --plan-cache``:
    the prefill step (patches fp32, positions int64) and the decode step
    trace on fake tensors and solve, a second run restores both plans, and
    the greedy tokens are equal; no kernel launches on the CPU."""
    def run():
        ops.reset_launch_counts()
        gen = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "16", "--gen", "4", "--plan-cache", str(tmp_path)])
        assert not any(ops.launch_counts().values())
        return gen, capsys.readouterr().out

    cfg = get_smoke_config(ARCH)
    gen, out = run()
    assert gen.shape == (2, 4) and 0 <= int(gen.min()) and int(gen.max()) < cfg.vocab_size
    for role in ("prefill", "decode"):
        assert f"[plan] {role}: solved" in out, out
    again, out = run()
    assert torch.equal(again, gen)
    for role in ("prefill", "decode"):
        assert f"[plan] {role}: restored from cache" in out, out
    assert len(list(tmp_path.glob("*.json"))) == 2


def test_train_main_two_smoke_steps(capsys):
    """``train.main --arch qwen2-vl-7b --smoke --device cpu`` for 2 steps:
    finite losses, on batches equal to the reference's ``make_batch_fn``
    (zero patches, the arange in every channel)."""
    cfg = get_smoke_config(ARCH)
    got = train.make_batch_fn(cfg, 2, 32, 0, "cpu")(1)
    want = jax_train.make_batch_fn(jax_smoke_config(ARCH), 2, 32, 0)(1)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    losses = train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "32"])
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert "done:" in capsys.readouterr().out


def test_serve_batched_example_on_cpu():
    """``examples/serve_batched_torch.py --device cpu``: three families, each
    served twice with the same tokens."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "serve_batched_torch.py"),
                           "--device", "cpu"], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    for arch in ("qwen3-4b", "gemma3-4b", "mamba2-370m"):
        assert sum(line.startswith(arch) for line in lines) == 2, proc.stdout
    assert lines[-1] == "deterministic across repeats: OK"
