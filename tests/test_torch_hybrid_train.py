"""hymba's training in the port (repro_torch) against the JAX package on the CPU.

A hybrid layer runs attention (with its window, or global) and a Mamba-2
mixer on the same normed input and merges them; training takes the flash
gradient with the window beside the SSD scan's.  On hymba's smoke config
(global, window 16, window 16, global; fp32): the loss and every gradient
against ``jax.value_and_grad`` of the reference's loss, with remat,
without it and under an offload policy, at S 48 (past the window) and at
S 40 (which pads to the SSD's chunk of 16); remat and the policies changing
no bit; five ``build_train_step`` steps against the reference's jitted
step; the bf16 loss near the port's fp32 loss, on fp32 masters that the
Mamba-2 matrices share; ``train.main``; and the train step traced on
fake tensors, each flash backward node priced by its own window.  Inputs
are made from seeds with numpy.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro_torch.configs import get_smoke_config
from repro_torch.core.offload import remat_policy_for
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import bwd_flops, flops
from repro_torch.launch import train
from repro_torch.launch.steps import build_train_step
from repro_torch.models import build_model
from repro_torch.models.attention import _window
from repro_torch.models.convert import adamw_from_jax, params_from_jax
from repro_torch.models.transformer import layer_specs
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves

ARCH = "hymba-1.5b"
B = 2


@functools.lru_cache(maxsize=None)
def _jax():
    jcfg = jax_smoke_config(ARCH)
    jmodel = jax_build_model(jcfg)
    return jmodel, jmodel.init(jax.random.PRNGKey(0))


def _setup():
    jmodel, jparams = _jax()
    tcfg = get_smoke_config(ARCH)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu", torch.float32)
    return jmodel, jparams, build_model(tcfg, "cpu"), tparams, tcfg


def _batches(cfg, batch, S, steps):
    ds = JaxSyntheticTokens(cfg.vocab_size, S, batch, seed=0)
    return [ds.batch_at(i) for i in range(steps)]


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(S):
    """The reference's loss and gradients at B2 S``S`` (jitted, once a length)."""
    jmodel, jparams = _jax()
    batch = _jb(_batches(jmodel.cfg, B, S, 1)[0])
    (loss, _), grads = jax.jit(jax.value_and_grad(lambda p: jmodel.loss(p, batch),
                                                  has_aux=True))(jparams)
    return float(loss), jax.tree.map(np.asarray, grads)


def _leaf_rel(got_tree, want_np_tree, tcfg):
    want = tree_leaves(params_from_jax(want_np_tree, tcfg, "cpu", torch.float32))
    return [((g.detach().float() - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
            for g, w in zip(tree_leaves(got_tree), want)]


def _grads(tmodel, tparams, batch, **kw):
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = tmodel.loss(tparams, batch, **kw)
    return loss, metrics, torch.autograd.grad(loss, leaves)


def test_smoke_program_has_window_and_global_layers():
    cfg = get_smoke_config(ARCH)
    specs = layer_specs(cfg.program)
    assert [spec.attn for spec in specs] == ["hybrid"] * 4
    assert [_window(spec) for spec in specs] == [None, 16, 16, None]


# fp32 at test_torch_ssm_train.py's tolerances: the loss 1e-5, each gradient
# 1e-4 of its leaf's max.  S 48 runs past the window of 16; S 40 pads to the
# smoke config's SSD chunk of 16 (48).
@pytest.mark.parametrize("S,how", [(48, "remat"), (48, "no-remat"), (48, "policy"),
                                   (40, "remat"), (40, "policy")])
def test_loss_and_grads_match_jax(S, how):
    _, _, tmodel, tparams, tcfg = _setup()
    jloss, jgrads = _jax_loss_and_grads(S)
    policy = remat_policy_for(["block_in", "attn_out"]).policy() if how == "policy" else None
    tloss, tm, grads = _grads(tmodel, tparams, _tb(_batches(tcfg, B, S, 1)[0]),
                              remat=how != "no-remat", remat_policy=policy)
    tloss = float(tloss.detach())
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    assert float(tm["ce"].detach()) == tloss and float(tm["aux"]) == 0.0
    rel = _leaf_rel(grads, jgrads, tcfg)
    assert len(rel) == len(grads) and max(rel) < 1e-4, max(rel)
    if policy is not None:  # both labels of every hybrid layer, one [B, S, d] fp32 each
        act = B * S * tcfg.d_model * 4
        assert policy.bytes_d2h == policy.bytes_h2d == 2 * tcfg.num_layers * act


def test_remat_and_the_policy_change_no_number():
    """No remat, remat, and remat under offload policies of ``attn_out`` (the
    merged branches) and of both labels give the same loss and gradients
    bit for bit."""
    _, _, tmodel, tparams, tcfg = _setup()
    batch = _tb(_batches(tcfg, B, 48, 1)[0])
    out = []
    for remat, names in ((False, None), (True, None), (True, ["attn_out"]),
                         (True, ["block_in", "attn_out"])):
        policy = remat_policy_for(names).policy() if names else None
        loss, _, grads = _grads(tmodel, tparams, batch, remat=remat, remat_policy=policy)
        out.append([loss.detach(), *grads])
    assert all(torch.equal(a, b) for run in out[1:] for a, b in zip(out[0], run))


def test_five_train_steps_match_jax():
    """Losses to 1e-5, grad norms and the final params to 1e-4, as
    tests/test_torch_train.py holds qwen3's; the reference's AdamW state,
    carried across by ``adamw_from_jax``, to the port's at 1e-4 too."""
    jmodel, jparams, tmodel, tparams, tcfg = _setup()
    S = 48
    jstep = jax.jit(jax_build_train_step(jmodel, jmodel.cfg))
    tstep = build_train_step(tmodel, tcfg)
    jopt, topt = jax_adamw.adamw_init(jparams), adamw.adamw_init(tparams)
    for i, b in enumerate(_batches(tcfg, B, S, 5)):
        jparams, jopt, jm = jstep(jparams, jopt, _jb(b), jnp.asarray(i, jnp.int32))
        tparams, topt, tm = tstep(tparams, topt, _tb(b), i)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-4 * float(jm["grad_norm"])
    assert topt.count == int(jopt.count) == 5
    rel = _leaf_rel(tparams, jax.tree.map(np.asarray, jparams), tcfg)
    assert max(rel) < 1e-4, max(rel)
    carried = adamw_from_jax(jax.tree.map(np.asarray, jopt), tcfg, "cpu")
    for got, want in zip(tree_leaves((topt.m, topt.v)), tree_leaves((carried.m, carried.v))):
        assert got.dtype == want.dtype == torch.float32
        assert ((got - want).abs().max() / want.abs().max()).item() < 1e-4


# The reference's bf16 SSD casts its decays to bf16 (ROADMAP queue C), so bf16
# is held to the port's own fp32 loss on the same masters and batch, at
# test_torch_ssm_train.py's 5e-4.
def test_bf16_loss_is_near_the_fp32_loss():
    _, _, _, tparams, tcfg = _setup()
    batch = _tb(_batches(tcfg, B, 48, 1)[0])
    f32 = float(build_model(tcfg, "cpu").loss(tparams, batch)[0])
    bf16 = build_model(tcfg.reduced(dtype="bfloat16"), "cpu")
    masters = bf16.init(torch.Generator().manual_seed(0), torch.float32)
    assert all(t.dtype == torch.float32 for t in tree_leaves(masters))
    assert {"in_proj", "out_proj"} <= set(masters["blocks"][0]["mamba"])
    got = bf16.loss(tparams, batch)
    assert got[0].dtype == torch.float32
    assert abs(float(got[0]) - f32) <= 5e-4 * abs(f32), (float(got[0]), f32)
    _, _, grads = _grads(bf16, tparams, batch)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)


def test_train_main_trains_the_smoke_model(tmp_path, capsys):
    """``train.main --arch hymba-1.5b --smoke --device cpu``, then with
    ``--plan`` and a plan cache, which a second run restores; the losses
    equal, and no kernel launched (plain versions only)."""
    ops.reset_launch_counts()
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "40", "--log-every", "1"]
    losses = train.main(argv)
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses)) and "done: first-loss" in out
    planned = train.main(argv + ["--plan", "--plan-cache", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[plan] vars=" in out and "(restored from cache)" not in out
    assert planned == losses
    train.main(argv + ["--plan", "--plan-cache", str(tmp_path)])
    assert "(restored from cache)" in capsys.readouterr().out
    assert not any(ops.launch_counts().values())


def test_train_step_traces_on_fake_tensors():
    """The hymba smoke loss and its gradient under remat, traced on fake
    tensors: flash with the LSE and the SSD scan once a layer in the forward
    and once in its recompute, each one's backward once a layer; each flash
    backward priced at 10 B H hd times the live pairs of its layer's window,
    each SSD node by its chunking's count; both labels named; no launch."""
    import repro_torch.core.trace as P

    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, "cpu")
    params = model.init_shapes(torch.float32)
    S = 40
    batch = {k: torch.empty(B, S, dtype=torch.long, device="meta") for k in ("tokens", "labels")}

    def step(p, b):
        leaves = tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        return torch.autograd.grad(model.loss(p, b)[0], leaves)

    ops.reset_launch_counts()
    gm = P.capture_graph(step, params, batch)
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"]

    def named(op):
        return [n for n in nodes if str(n.target) == f"repro_torch.{op}.default"]

    L = cfg.num_layers
    assert len(named("flash_attention_lse")) == len(named("ssd_scan")) == 2 * L
    assert len(named("flash_attention_bwd")) == len(named("ssd_scan_bwd")) == L
    H, hd = cfg.num_heads, cfg.head_dim
    windows = sorted(_window(s) or S for s in layer_specs(cfg.program))
    priced = sorted(P._node_cost(n)[0] / (10 * B * H * hd) for n in named("flash_attention_bwd"))
    assert priced == sorted(P._live_pairs(S, S, True, w if w < S else None) for w in windows)
    assert priced[0] < priced[-1]  # the window layers' nodes cost less than the global ones'
    s_pad = -(-S // cfg.ssm_chunk) * cfg.ssm_chunk
    dims = (B, s_pad, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    assert all(P._node_cost(n)[0] == flops(*dims) for n in named("ssd_scan"))
    assert all(P._node_cost(n)[0] == bwd_flops(*dims) for n in named("ssd_scan_bwd"))
    assert not any(ops.launch_counts().values())
    tr = P.trace_graph(gm, P._leaf_paths((params, batch)))
    assert tr.peak_load() > 0
    assert {"block_in", "attn_out", "ffn_out"} <= {v.name for v in tr.variables}
