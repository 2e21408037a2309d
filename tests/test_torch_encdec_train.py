"""whisper-large-v3's training in the port (repro_torch) against the JAX
package on the CPU.

``EncDecModel.loss`` runs the encoder (unmasked self attention at Sq = Sk =
enc_seq, no remat), then each decoder layer (causal self attention, then
cross attention of the decoder's queries against the encoder's keys, Sq !=
Sk) under per-layer remat or an offload policy, and the chunked loss.  The
encoder's only gradient comes through the cross attentions.  On whisper's
smoke config (2 + 2 layers, 24 frames; fp32), with every norm scale, norm
bias and FFN bias drawn at random in place of init's ones and zeros, and
frames drawn with numpy from a seed: the loss and every gradient leaf, the
encoder's included, against ``jax.value_and_grad`` of the reference's
``EncDecModel.loss``, with remat, without it and under an offload policy
(loss 1e-5, each leaf 1e-4 of its max, as tests/test_torch_hybrid_train.py
holds hymba's); remat and the policies changing no bit; five
``build_train_step`` steps against the reference's jitted step, at
``accum_steps`` 1 and 2 (which cuts the frames along B); the bf16 loss near
the fp32 loss; ``train.main`` with frames in its batch; the loss traced on
fake tensors with ``step_planner``'s probe; and the flash operators the
loss and its gradient reach, with their flags.
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
from repro_torch.launch import train
from repro_torch.launch.steps import build_train_step
from repro_torch.models import build_model
from repro_torch.models.convert import adamw_from_jax, params_from_jax
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves

ARCH = "whisper-large-v3"
B, S = 2, 12
# The port in bf16 against the reference in fp32 on the same masters, as
# tests/test_torch_encdec.py holds whisper's serving (BF16_VS_FP32_TOL).
BF16_VS_FP32_TOL = 5e-2


def _random_vectors(params, seed: int):
    """``params`` with every norm scale drawn from 1 + N(0, 0.09), and every
    norm bias and FFN bias from N(0, 0.09), so that a gradient taken to the
    wrong one shows."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        key = jax.tree_util.keystr(path)
        if key.endswith("['scale']"):
            return (1.0 + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        if key.endswith("['bias']") or key.endswith("['b_up']") or key.endswith("['b_down']"):
            return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        return np.asarray(a)

    return jax.tree_util.tree_map_with_path(draw, params)


@functools.lru_cache(maxsize=None)
def _jax():
    jmodel = jax_build_model(jax_smoke_config(ARCH))
    return jmodel, _random_vectors(jmodel.init(jax.random.PRNGKey(0)), 7)


def _setup():
    jmodel, jparams = _jax()
    tcfg = get_smoke_config(ARCH)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu", torch.float32)
    return jmodel, jparams, build_model(tcfg, "cpu"), tparams, tcfg


def _batches(cfg, batch, seq, steps):
    """The reference's token batches, each with standard normal frames
    [batch, enc_seq, d_model] from its own seed."""
    ds = JaxSyntheticTokens(cfg.vocab_size, seq, batch, seed=0)
    return [dict(ds.batch_at(i), frames=np.random.default_rng(100 + i).standard_normal(
        (batch, cfg.enc_seq, cfg.d_model), dtype=np.float32)) for i in range(steps)]


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) if k == "frames" else torch.from_numpy(v).long()
            for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
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


def _unflatten(tparams, grads):
    """The gradient leaves in ``tparams``' tree: {"encoder": [...], ...}."""
    it = iter(grads)
    return jax.tree.map(lambda _: next(it), tparams,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))


@pytest.mark.parametrize("how", ["remat", "no-remat", "policy"])
def test_loss_and_grads_match_jax(how):
    """The loss within 1e-5 and every gradient leaf within 1e-4 of its max:
    the encoder's leaves (reached only through the cross attentions'
    unmasked flash gradient at Sq 12 against Sk 24, and the encoder's own
    at Sq = Sk 24) as the decoder's."""
    _, _, tmodel, tparams, tcfg = _setup()
    jloss, jgrads = _jax_loss_and_grads()
    policy = remat_policy_for(["block_in"]).policy() if how == "policy" else None
    tloss, tm, grads = _grads(tmodel, tparams, _tb(_batches(tcfg, B, S, 1)[0]),
                              remat=how != "no-remat", remat_policy=policy)
    tloss = float(tloss.detach())
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    assert float(tm["ce"].detach()) == tloss and float(tm["aux"]) == 0.0
    rel = _leaf_rel(grads, jgrads, tcfg)
    assert len(rel) == len(grads) and max(rel) < 1e-4, max(rel)
    enc = tree_leaves(_unflatten(tparams, grads)["encoder"])
    assert enc and all(float(g.abs().max()) > 0 for g in enc)
    if policy is not None:  # block_in of every decoder layer, one [B, S, d] fp32 each
        act = B * S * tcfg.d_model * 4
        assert policy.bytes_d2h == policy.bytes_h2d == tcfg.num_layers * act


def test_remat_and_the_policy_change_no_number():
    """No remat, remat, and remat under offload policies of ``block_in`` and
    of all three labels give the same loss and gradients bit for bit, the
    encoder's too: a policy that dropped the encoder output's gradient (a
    tensor the layer only closed over) would leave the encoder's leaves
    with the encoder's own gradient alone."""
    _, _, tmodel, tparams, tcfg = _setup()
    batch = _tb(_batches(tcfg, B, S, 1)[0])
    out = []
    for remat, names in ((False, None), (True, None), (True, ["block_in"]),
                         (True, ["block_in", "attn_out", "ffn_out"])):
        policy = remat_policy_for(names).policy() if names else None
        loss, _, grads = _grads(tmodel, tparams, batch, remat=remat, remat_policy=policy)
        out.append([loss.detach(), *grads])
    assert all(torch.equal(a, b) for run in out[1:] for a, b in zip(out[0], run))


@pytest.mark.parametrize("accum", [1, 2])
def test_five_train_steps_match_jax(accum):
    """Losses to 1e-5, grad norms and the final params to 1e-4, as
    tests/test_torch_train.py holds qwen3's; the reference's AdamW state,
    carried across by ``adamw_from_jax``, to the port's at 1e-4 too.  With
    ``accum_steps`` 2 both cut the batch, frames included, along B."""
    jmodel, jparams, tmodel, tparams, tcfg = _setup()
    jstep = jax.jit(jax_build_train_step(jmodel, jmodel.cfg, accum_steps=accum))
    tstep = build_train_step(tmodel, tcfg, accum_steps=accum)
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


def test_bf16_loss_is_near_the_fp32_loss():
    """The port in bf16 (each use casting the fp32 masters) against the
    reference's fp32 loss on the same masters and batch, within
    BF16_VS_FP32_TOL relative; every gradient an fp32 leaf, finite."""
    _, _, _, tparams, tcfg = _setup()
    jloss, _ = _jax_loss_and_grads()
    batch = _tb(_batches(tcfg, B, S, 1)[0])
    bf16 = build_model(tcfg.reduced(dtype="bfloat16"), "cpu")
    loss, _, grads = _grads(bf16, tparams, batch)
    assert loss.dtype == torch.float32
    assert abs(float(loss.detach()) - jloss) <= BF16_VS_FP32_TOL * abs(jloss), \
        (float(loss), jloss)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)


def test_train_main_trains_the_smoke_model(tmp_path, capsys):
    """``train.main --arch whisper-large-v3 --smoke --device cpu``: its batch
    holds the reference's zero frames; then with ``--plan`` and a plan
    cache, which a second run restores; the losses equal, and no kernel
    launched (plain versions only)."""
    cfg = get_smoke_config(ARCH)
    batch = train.make_batch_fn(cfg, 2, 16, 0, "cpu")(0)
    assert set(batch) == {"tokens", "labels", "frames"}
    frames = batch["frames"]
    assert frames.shape == (2, cfg.enc_seq, cfg.d_model) and frames.dtype == torch.float32
    assert not frames.any()
    ops.reset_launch_counts()
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "16", "--log-every", "1"]
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


def test_loss_traces_with_the_planners_probe():
    """``train.step_planner``'s probe (tokens, labels and meta frames) traces
    whisper's loss on fake tensors: a plan with every label named, its peak
    load above the fp32 masters' bytes, and no launch."""
    cfg = get_smoke_config(ARCH)
    ops.reset_launch_counts()
    planner = train.step_planner(build_model(cfg, "cpu"), ARCH, B, S, True)
    rep = planner.report()
    masters = sum(t.numel() * 4 for t in tree_leaves(build_model(cfg, "cpu").init_shapes(
        torch.float32)))
    assert rep.num_variables > 0 and rep.peak_load >= masters
    assert {"block_in", "attn_out", "ffn_out"} <= {v.name for v in planner.trace.variables}
    assert not any(ops.launch_counts().values())


def test_loss_and_grad_reach_flash_with_its_flags():
    """The loss and its gradient under remat, traced on fake tensors: flash
    with the LSE 5 L times (each encoder layer once, unmasked at Sq = Sk =
    enc_seq; each decoder layer's causal self attention and unmasked cross
    attention, Sq S against Sk enc_seq, twice: its forward and its
    recompute), its backward 3 L times (L of each kind), each node priced
    by its own flags, and no RMSNorm (every norm is a LayerNorm)."""
    import repro_torch.core.trace as P

    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, "cpu")
    params = model.init_shapes(torch.float32)
    batch = {k: torch.empty(B, S, dtype=torch.long, device="meta") for k in ("tokens", "labels")}
    batch["frames"] = torch.empty(B, cfg.enc_seq, cfg.d_model, device="meta")

    def step(p, b):
        leaves = tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        return torch.autograd.grad(model.loss(p, b)[0], leaves)

    gm = P.capture_graph(step, params, batch)
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"]

    def flags(op, at):
        return sorted((n.args[at], n.args[0].meta["val"].shape[1], n.args[1].meta["val"].shape[1])
                      for n in nodes if str(n.target) == f"repro_torch.{op}.default")

    L, Se = cfg.num_layers, cfg.enc_seq
    assert L == 2 and sum(len(u) * r for u, r in cfg.enc_program) == L
    enc, self_, cross = (False, Se, Se), (True, S, S), (False, S, Se)
    assert flags("flash_attention_lse", 3) == sorted([enc] * L + [self_, cross] * 2 * L)
    assert flags("flash_attention_bwd", 6) == sorted([enc, self_, cross] * L)
    assert not [n for n in nodes if "rmsnorm" in str(n.target)]
    H, hd = cfg.num_heads, cfg.head_dim
    priced = sorted(P._node_cost(n)[0] / (10 * B * H * hd) for n in nodes
                    if str(n.target) == "repro_torch.flash_attention_bwd.default")
    assert priced == sorted([Se * Se, S * (S + 1) // 2, S * Se] * L)
