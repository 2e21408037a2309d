"""Mamba-2 training in the port (repro_torch) against the JAX package on the CPU.

The SSD scan's gradient: ``ssd_scan_bwd_plain`` (the closed form the CPU
runs and the backward kernel is held to on the card) against ``jax.vjp`` of
the reference's ``ssd_chunked`` and its sequential oracle
``ssd_reference``, and against PyTorch's autograd of ``ssd_scan_plain``;
the gradient registered on ``repro_torch::ssd_scan`` through ``ops.ssd``;
``opcheck`` of ``repro_torch::ssd_scan_bwd`` and its fake implementation;
the chunkings' FLOP counts.  Then the mamba2 smoke model: the loss and
every gradient against ``jax.value_and_grad`` (with remat, without, and
under an offload policy, which sees ``attn_out`` on a Mamba-2 layer), at a
length that pads to the chunk, five ``build_train_step`` steps against the
reference's jitted step, the train driver, the train step traced on fake
tensors, and bf16 against the port's own fp32.  Inputs are made from
seeds with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.kernels.ref import ssd_reference
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models import build_model as jax_build_model
from repro.models.ssm import ssd_chunked
from repro.optim import adamw as jax_adamw
from repro_torch.configs import get_smoke_config
from repro_torch.core.offload import remat_policy_for
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import (CHUNK, bwd_flops, flops, ssd_scan_bwd_plain,
                                          ssd_scan_plain)
from repro_torch.launch import train
from repro_torch.launch.steps import build_train_step
from repro_torch.models import build_model
from repro_torch.models.convert import adamw_from_jax, params_from_jax
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves

ARCH = "mamba2-370m"
# Relative to each output's max, as tests/test_kernels.py holds the SSD:
# both sides are fp32 sums of the same terms in other orders (measured at
# most 2.6e-6 of an output's max against jax.vjp).
SSD_TOL = 1e-4


def _ssd_inputs(b, s, h, p, g, n, seed=0):
    """x, dt (softplus(N(0, 1) - 1)), A (-linspace(0.5, 4)), Bm, Cm as fp32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)).astype(np.float32)
    A = -np.linspace(0.5, 4.0, h, dtype=np.float32)
    Bm = rng.standard_normal((b, s, g, n), dtype=np.float32)
    Cm = rng.standard_normal((b, s, g, n), dtype=np.float32)
    return x, dt, A, Bm, Cm


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------- the scan's gradient
# (reference function, g, s, jax chunk, cotangent on the final state too):
# s = 100 is ragged for the port's 64-step chunks (64 + 36), while the
# reference's chunk divides it, as its ``ssd_chunked`` asserts.
VJP_CASES = {
    "chunked-g1": ("chunked", 1, 128, 32, False),
    "chunked-g2-ragged-state": ("chunked", 2, 100, 25, True),
    "chunked-g1-ragged-state": ("chunked", 1, 100, 50, True),
    "reference-g1-ragged": ("reference", 1, 100, None, False),
    "reference-g2": ("reference", 2, 128, None, False),
}


@pytest.mark.parametrize("case", list(VJP_CASES))
def test_plain_backward_matches_jax_vjp(case):
    ref, g, s, chunk, with_state = VJP_CASES[case]
    b, h, p, n = 2, 4, 8, 6
    ins = _ssd_inputs(b, s, h, p, g, n)
    rng = np.random.default_rng(1)
    dy = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dstate = (rng.standard_normal((b, h, p, n), dtype=np.float32) if with_state
              else np.zeros((b, h, p, n), np.float32))
    J = tuple(jnp.asarray(a) for a in ins)
    if ref == "chunked":
        _, vjp = jax.vjp(lambda *a: ssd_chunked(*a, chunk), *J)
        want = vjp((jnp.asarray(dy), jnp.asarray(dstate)))
    else:
        _, vjp = jax.vjp(ssd_reference, *J)
        want = vjp(jnp.asarray(dy))
    got = ssd_scan_bwd_plain(*(torch.from_numpy(a) for a in ins), torch.from_numpy(dy),
                             torch.from_numpy(dstate))
    for name, gt, w in zip(("dx", "ddt", "dA", "dBm", "dCm"), got, want):
        assert tuple(gt.shape) == w.shape and gt.dtype == torch.float32
        assert _rel(gt, w) < SSD_TOL, (name, _rel(gt, w))


@pytest.mark.parametrize("with_state", [False, True], ids=["y", "y-and-state"])
def test_operator_gradient_is_the_plain_backward(with_state):
    """``ops.ssd``'s registered gradient (``repro_torch::ssd_scan_bwd`` on CPU
    tensors) gives the plain backward's numbers bit for bit, and PyTorch's
    autograd of ``ssd_scan_plain`` within SSD_TOL; x, Bm and Cm are views
    of one tensor, as the model hands them over, and s pads a chunk."""
    b, s, h, p, g, n = 2, 150, 4, 8, 2, 6
    rng = np.random.default_rng(2)
    xbc = torch.from_numpy(rng.standard_normal((b, s, h * p + 2 * g * n), dtype=np.float32))
    _, dt, A, _, _ = (torch.from_numpy(a) for a in _ssd_inputs(b, s, h, p, g, n))
    dy = torch.from_numpy(rng.standard_normal((b, s, h, p), dtype=np.float32))
    dstate = torch.from_numpy(rng.standard_normal((b, h, p, n), dtype=np.float32))

    def leaves():
        base = xbc.clone().requires_grad_()
        x, Bm, Cm = (t.unflatten(-1, (k, d)) for t, k, d in zip(
            base.split([h * p, g * n, g * n], dim=-1), (h, g, g), (p, n, n)))
        d, a = dt.clone().requires_grad_(), A.clone().requires_grad_()
        return (base, d, a), (x, d, a, Bm, Cm)

    def grads(fn):
        (base, d, a), args = leaves()
        y, state = fn(*args)
        total = (y * dy).sum() + ((state * dstate).sum() if with_state else 0)
        return torch.autograd.grad(total, (base, d, a))

    _, args = leaves()
    plain = ssd_scan_bwd_plain(*(t.detach() for t in args), dy,
                               dstate if with_state else torch.zeros(b, h, p, n))
    got = grads(ops.ssd)
    want_x = torch.cat([plain[0].flatten(2), plain[3].flatten(2), plain[4].flatten(2)], -1)
    assert torch.equal(got[0], want_x)
    assert torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])
    autograd = grads(ssd_scan_plain)
    for gt, w in zip(got, autograd):
        assert _rel(gt, w) < SSD_TOL


def test_opcheck_of_the_backward_operator():
    from torch.library import opcheck

    b, s, h, p, g, n = 1, 70, 4, 8, 2, 4
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _ssd_inputs(b, s, h, p, g, n))
    rng = np.random.default_rng(3)
    dy = torch.from_numpy(rng.standard_normal((b, s, h, p), dtype=np.float32))
    dstate = torch.from_numpy(rng.standard_normal((b, h, p, n), dtype=np.float32))
    O = torch.ops.repro_torch
    for op, args in ((O.ssd_scan_bwd, (x, dt, A, Bm, Cm, dy, dstate)),
                     (O.ssd_scan, tuple(t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)))):
        result = opcheck(op, args)
        assert set(result.values()) == {"SUCCESS"}, (op, result)


def test_backward_fake_implementation_gives_the_real_shapes_and_strides():
    """On fake tensors the backward operator returns what its CPU and CUDA
    implementations return: each gradient contiguous in its input's shape
    and dtype, for strided views of x, Bm and Cm and bf16 alike."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    b, s, h, p, g, n = 2, 40, 4, 8, 2, 4
    for dtype in (torch.float32, torch.bfloat16):
        xbc = torch.randn(b, s, h * p + 2 * g * n).to(dtype)
        x, Bm, Cm = (t.unflatten(-1, (k, d)) for t, k, d in zip(
            xbc.split([h * p, g * n, g * n], dim=-1), (h, g, g), (p, n, n)))
        dt, A = torch.rand(b, s, h).to(dtype), -torch.ones(h).to(dtype)
        dy, dstate = torch.randn(b, s, h, p).to(dtype), torch.randn(b, h, p, n)
        real = torch.ops.repro_torch.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dstate)
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake = torch.ops.repro_torch.ssd_scan_bwd(
                *(mode.from_tensor(t) for t in (x, dt, A, Bm, Cm, dy, dstate)))
        for r, f, inp in zip(real, fake, (x, dt, A, Bm, Cm)):
            assert f.shape == r.shape == inp.shape and f.dtype == r.dtype == inp.dtype
            assert f.stride() == r.stride() and r.is_contiguous()


def test_flop_counts_are_pinned():
    """The chunkings' counts, which the tracer prices the operators by and
    ``chip_smoke.py`` bounds the kernels with: at mamba2's training shape
    (B4 S2048 H32 P64 N128: 32 chunks of 64), and at a ragged length (100 =
    64 + 36) worked by hand."""
    assert CHUNK == 64
    # a chunk of 64: 2080 (N + P) + 2 * 64 P N, and 2080 (3 N + 2 P) + 5 * 64 P N
    assert flops(4, 2048, 32, 64, 128) == 2 * 4 * 32 * 32 * (2080 * 192 + 2 * 64 * 64 * 128)
    assert flops(4, 2048, 32, 64, 128) == 11_861_491_712
    assert bwd_flops(4, 2048, 32, 64, 128) == 30_198_988_800
    # chunks of 64 and 36 at b1 h2 p8 n6: c (c + 1) / 2 is 2080 and 666
    assert flops(1, 100, 2, 8, 6) == 2 * 2 * ((2080 + 666) * 14 + 2 * 100 * 8 * 6)
    assert bwd_flops(1, 100, 2, 8, 6) == 2 * 2 * ((2080 + 666) * (18 + 16) + 5 * 100 * 8 * 6)


# ------------------------------------------------------------- the model
def _setup(seed=0):
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu", torch.float32)
    return jmodel, jparams, build_model(tcfg, "cpu"), tparams, tcfg


def _batches(cfg, B, S, steps):
    ds = JaxSyntheticTokens(cfg.vocab_size, S, B, seed=0)
    return [ds.batch_at(i) for i in range(steps)]


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _leaf_rel(got_tree, want_np_tree, tcfg):
    want = tree_leaves(params_from_jax(want_np_tree, tcfg, "cpu", torch.float32))
    return [((g.detach().float() - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
            for g, w in zip(tree_leaves(got_tree), want)]


# fp32 at test_torch_train.py's tolerances: the loss 1e-5, each gradient 1e-4
# of its leaf's max.  S = 40 pads to the smoke config's chunk of 16 (48).
@pytest.mark.parametrize("S,how", [(32, "remat"), (32, "no-remat"), (32, "policy"),
                                   (40, "remat")])
def test_loss_and_grads_match_jax(S, how):
    jmodel, jparams, tmodel, tparams, tcfg = _setup()
    B = 2
    batch = _batches(tcfg, B, S, 1)[0]
    (jloss, _), jgrads = jax.value_and_grad(lambda p: jmodel.loss(p, _jb(batch)),
                                            has_aux=True)(jparams)
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    policy = remat_policy_for(["block_in", "attn_out"]).policy() if how == "policy" else None
    tloss, tm = tmodel.loss(tparams, _tb(batch), remat=how != "no-remat", remat_policy=policy)
    grads = torch.autograd.grad(tloss, leaves)
    tloss = float(tloss.detach())
    assert abs(tloss - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert float(tm["ce"].detach()) == tloss and float(tm["aux"]) == 0.0
    rel = _leaf_rel(grads, jax.tree.map(np.asarray, jgrads), tcfg)
    assert len(rel) == len(leaves) and max(rel) < 1e-4, max(rel)
    if policy is not None:  # it saw both labels of every Mamba-2 layer, one [B, S, d] fp32 each
        act = B * S * tcfg.d_model * 4
        assert policy.bytes_d2h == policy.bytes_h2d == 2 * tcfg.num_layers * act


def test_remat_and_the_policy_change_no_number():
    """No remat, remat, and remat under an offload policy of ``block_in`` and
    ``attn_out`` give the same loss and gradients bit for bit."""
    _, _, tmodel, tparams, tcfg = _setup()
    batch = _tb(_batches(tcfg, 2, 32, 1)[0])
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    out = []
    for remat, names in ((False, None), (True, None), (True, ["attn_out"]),
                         (True, ["block_in", "attn_out"])):
        policy = remat_policy_for(names).policy() if names else None
        loss, _ = tmodel.loss(tparams, batch, remat=remat, remat_policy=policy)
        out.append([loss.detach(), *torch.autograd.grad(loss, leaves)])
    assert all(torch.equal(a, b) for run in out[1:] for a, b in zip(out[0], run))


def test_five_train_steps_match_jax():
    """Losses to 1e-5, grad norms and the final params to 1e-4, as
    tests/test_torch_train.py holds qwen3's; the reference's AdamW state,
    carried across by ``adamw_from_jax``, to the port's at 1e-4 too."""
    jmodel, jparams, tmodel, tparams, tcfg = _setup()
    B, S = 4, 32
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
    assert carried.count == 5
    for got, want in zip(tree_leaves((topt.m, topt.v)), tree_leaves((carried.m, carried.v))):
        assert got.dtype == want.dtype == torch.float32
        assert ((got - want).abs().max() / want.abs().max()).item() < 1e-4


# The reference's bf16 SSD casts its decays to bf16 (ROADMAP queue C), so bf16
# is held to the port's own fp32 loss on the same masters and batch: measured
# 4.2e-5 relative on this smoke model, held to 5e-4.
def test_bf16_loss_is_near_the_fp32_loss():
    _, _, _, tparams, tcfg = _setup()
    batch = _tb(_batches(tcfg, 2, 32, 1)[0])
    f32 = float(build_model(tcfg, "cpu").loss(tparams, batch)[0])
    bf16 = build_model(tcfg.reduced(dtype="bfloat16"), "cpu")
    got = bf16.loss(tparams, batch)
    assert got[0].dtype == torch.float32
    assert abs(float(got[0]) - f32) <= 5e-4 * abs(f32), (float(got[0]), f32)
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    grads = torch.autograd.grad(bf16.loss(tparams, batch)[0], leaves)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)


def test_train_main_trains_the_smoke_model(tmp_path, capsys):
    """``train.main --arch mamba2-370m --smoke --device cpu``, then with
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
    """The mamba2 smoke loss and its gradient under remat, traced on fake
    tensors: one ``ssd_scan`` node a layer in the forward and one in its
    recompute, one ``ssd_scan_bwd`` a layer, each priced by its chunking's
    count; no launch."""
    import repro_torch.core.trace as P

    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, "cpu")
    params = model.init_shapes(torch.float32)
    B, S = 2, 40
    batch = {k: torch.empty(B, S, dtype=torch.long, device="meta") for k in ("tokens", "labels")}

    def step(p, b):
        leaves = tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        return torch.autograd.grad(model.loss(p, b)[0], leaves)

    ops.reset_launch_counts()
    gm = P.capture_graph(step, params, batch)
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"]
    fwd = [n for n in nodes if str(n.target) == "repro_torch.ssd_scan.default"]
    bwd = [n for n in nodes if str(n.target) == "repro_torch.ssd_scan_bwd.default"]
    assert len(fwd) == 2 * cfg.num_layers and len(bwd) == cfg.num_layers
    s_pad = -(-S // cfg.ssm_chunk) * cfg.ssm_chunk
    dims = (B, s_pad, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    assert all(P._node_cost(n)[0] == flops(*dims) for n in fwd)
    assert all(P._node_cost(n)[0] == bwd_flops(*dims) for n in bwd)
    assert not any(ops.launch_counts().values())
    tr = P.trace_graph(gm, P._leaf_paths((params, batch)))
    assert tr.peak_load() > 0
    assert {"block_in", "attn_out"} <= {v.name for v in tr.variables}


def test_padded_steps_get_no_gradient_through_the_pad():
    """At a length that pads to the chunk, the padded steps (dt = 0) carry
    gradients into ``F.pad``'s backward, which drops them: the loss's
    gradient with respect to the inputs of the scan equals the one of the
    same scan on the unpadded length."""
    b, s, h, p, g, n = 1, 40, 2, 4, 1, 3
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _ssd_inputs(b, s, h, p, g, n))
    rng = np.random.default_rng(4)
    dy = torch.from_numpy(rng.standard_normal((b, s, h, p), dtype=np.float32))

    def grads(pad):
        leaves = [t.clone().requires_grad_() for t in (x, dt, Bm, Cm)]
        xx, dd, bb, cc = leaves
        if pad:
            xx, bb, cc = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xx, bb, cc))
            dd = F.pad(dd, (0, 0, 0, pad))
        y, _ = ops.ssd(xx, dd, A, bb, cc)
        return torch.autograd.grad((y[:, :s] * dy).sum(), leaves)

    for a, w in zip(grads(24), grads(0)):
        assert _rel(a, w) < SSD_TOL
