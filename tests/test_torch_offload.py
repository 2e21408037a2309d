"""Executing an offload plan in the port (``OffloadPlan.policy()``,
``Model.loss(remat_policy=)``, ``train --hbm-limit-gb``) on the CPU.

Under each policy the loss and every gradient are bit-equal to plain remat's
(the copies are exact and the recompute is deterministic), and they match
the JAX model's under the reference's ``save_and_offload_only_these_names``
policy at the tolerances of ``tests/test_torch_train.py``: for qwen3-4b
smoke, and for deepseek-v2-lite smoke (MLA and MoE layers, whose aux loss
leaves each layer beside its output), its aux loss too.  The policy
counts the bytes it moves each way, and the recompute continues from the
fetched copy where it reaches an offloaded label.
"""

import re
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.offload import OffloadPlan as JaxOffloadPlan
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.core.offload import KNOWN_NAMES, OffloadPlan, remat_policy_for
from repro_torch.core.offload_exec import OffloadPolicy
from repro_torch.kernels import ops
from repro_torch.kernels.ops import label, label_hook
from repro_torch.launch import train
from repro_torch.launch.steps import build_train_step
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves

ARCH = "qwen3-4b"
B, S = 2, 32
# (offload_names, save_names): each label offloaded alone, all three, and a
# saved one.
PLANS = [(["block_in"], []), (["attn_out"], []), (["ffn_out"], []), (list(KNOWN_NAMES), []),
         ([], ["attn_out"])]
PLAN_IDS = ["block_in", "attn_out", "ffn_out", "all", "save-attn_out"]


def _setup(seed: int = 0, arch: str = ARCH):
    jcfg = jax_smoke_config(arch).reduced(dtype="float32")
    tcfg = get_smoke_config(arch).reduced(dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu", torch.float32)
    batch = JaxSyntheticTokens(tcfg.vocab_size, S, B, seed=0).batch_at(0)
    return jmodel, jparams, build_model(tcfg, "cpu"), tparams, tcfg, batch


def _tb(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _loss_and_grads(model, params, batch, policy):
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = model.loss(params, batch, remat_policy=policy)
    return [loss.detach(), metrics["aux"].detach(), *torch.autograd.grad(loss, leaves)]


# -------------------------------------------------------------- the policy
def test_offload_policy_builds_and_applies():
    """The counterpart of the reference's test of the same name
    (``tests/test_planner.py``): an empty plan is plain remat (no policy),
    a named one builds a policy, and a function run under it still
    differentiates as without it."""
    assert remat_policy_for([]).policy() is None
    assert OffloadPlan().policy() is None
    pol = remat_policy_for(["block_in"]).policy()
    assert isinstance(pol, OffloadPolicy) and pol.offload_names == {"block_in"}
    assert isinstance(OffloadPlan(save_names=["attn_out"]).policy(), OffloadPolicy)

    def f(x):
        return torch.tanh(label(x, "block_in") @ w)

    gen = torch.Generator().manual_seed(0)
    w = torch.randn(8, 8, generator=gen, requires_grad=True)
    x = torch.randn(4, 8, generator=gen, requires_grad=True)
    g1 = torch.autograd.grad((pol.run_layer(f, x, [w]) ** 2).sum(), (w, x))
    g2 = torch.autograd.grad((f(x) ** 2).sum(), (w, x))
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert pol.bytes_d2h == pol.bytes_h2d == x.numel() * 4


def _bit_equal_to_plain_remat(offload, save, arch):
    _, _, model, params, _, batch = _setup(arch=arch)
    batch = _tb(batch)
    plain = _loss_and_grads(model, params, batch, None)
    got = _loss_and_grads(model, params, batch,
                          OffloadPlan(offload_names=offload, save_names=save).policy())
    assert len(got) == len(plain)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


@pytest.mark.parametrize("offload,save", PLANS, ids=PLAN_IDS)
def test_policy_is_bit_equal_to_plain_remat(offload, save):
    _bit_equal_to_plain_remat(offload, save, ARCH)


# deepseek-v2-lite smoke: MLA in every layer, a dense FFN then two MoE FFNs,
# whose aux losses leave each layer beside its output (``train_layer``'s
# (x, aux)) and take their gradient in the policy's backward.
MOE_ARCH = "deepseek-v2-lite-16b"


@pytest.mark.parametrize("offload,save", PLANS, ids=PLAN_IDS)
def test_moe_policy_is_bit_equal_to_plain_remat(offload, save):
    _bit_equal_to_plain_remat(offload, save, MOE_ARCH)


# Tolerances of tests/test_torch_train.py's JAX comparison at smoke fp32.
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _matches_jax_under_the_reference_policy(offload, save, arch):
    jmodel, jparams, model, params, tcfg, batch = _setup(arch=arch)
    jpol = JaxOffloadPlan(offload_names=offload, save_names=save).policy()
    jbatch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    # The reference's offload policy moves residuals with TransferToMemoryKind,
    # which JAX permits only under jit (as its own test runs it).
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, remat=True, remat_policy=jpol), has_aux=True))(jparams)
    got = _loss_and_grads(model, params, _tb(batch),
                          OffloadPlan(offload_names=offload, save_names=save).policy())
    assert abs(float(got[0]) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    assert abs(float(got[1]) - float(jm["aux"])) <= LOSS_TOL * abs(float(jm["aux"]))
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg, "cpu",
                                       torch.float32))
    rel = [((g - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
           for g, w in zip(got[2:], want)]
    assert len(rel) == len(want) and max(rel) < GRAD_TOL, max(rel)


@pytest.mark.parametrize("offload,save", PLANS, ids=PLAN_IDS)
def test_policy_matches_jax_under_the_reference_policy(offload, save):
    _matches_jax_under_the_reference_policy(offload, save, ARCH)


# The batch of seed 0 routes the deepseek smoke model with its smallest
# top-2 margin 6.1e-4 (tests/test_torch_moe_train.py holds the routing equal
# to the reference's at this batch and these parameters).
@pytest.mark.parametrize("offload,save", PLANS, ids=PLAN_IDS)
def test_moe_policy_matches_jax_under_the_reference_policy(offload, save):
    _matches_jax_under_the_reference_policy(offload, save, MOE_ARCH)


@pytest.mark.parametrize("names", [["block_in"], list(KNOWN_NAMES)], ids=["block_in", "all"])
def test_bytes_moved_are_the_offloaded_labels(names):
    """A train step offloads each offloaded label of each layer once and
    fetches it back once: B x S x d_model x 4 bytes each (fp32 smoke).  The
    host buffers are made in the first step and reused in the second."""
    _, _, model, params, tcfg, _ = _setup()
    policy = remat_policy_for(names).policy()
    step = build_train_step(model, tcfg, remat_policy=policy)
    opt = adamw_init(params)
    ds = JaxSyntheticTokens(tcfg.vocab_size, S, B, seed=0)
    want = tcfg.num_layers * len(names) * B * S * tcfg.d_model * 4
    for i in range(2):
        params, opt, _ = step(params, opt, _tb(ds.batch_at(i)), i)
        assert (policy.bytes_d2h, policy.bytes_h2d) == ((i + 1) * want, (i + 1) * want)
        assert sum(len(b) for b in policy._free.values()) == tcfg.num_layers * len(names)


def test_the_recompute_continues_from_the_fetched_copy():
    """A layer whose labelled value changes between its forward and its
    recompute (a counter, standing for any difference): plain remat's
    gradient uses the recomputed value, the policy's the offloaded or saved
    copy, as the reference's policy does.  y = h^2 with h = x * s, s = 1 in
    the forward and 2 in the recompute: dy/dx = 2 h_used * 2, with h_used
    2x recomputed or x stored."""
    x = torch.arange(1.0, 5.0, requires_grad=True)

    def run(policy):
        calls = []

        def layer(x):
            calls.append(None)
            scale = torch.tensor(float(len(calls)))  # a tensor, so autograd saves it
            return label(label(x, "block_in") * scale, "attn_out") ** 2

        if policy is None:
            y = torch.utils.checkpoint.checkpoint(layer, x, use_reentrant=False)
        else:
            y = policy.run_layer(layer, x, [])
        return torch.autograd.grad(y.sum(), x)[0]

    assert torch.equal(run(None), 8 * x.detach())
    assert torch.equal(run(remat_policy_for(["block_in"]).policy()), 8 * x.detach())
    assert torch.equal(run(remat_policy_for(["attn_out"]).policy()), 4 * x.detach())
    assert torch.equal(run(OffloadPlan(save_names=["attn_out"]).policy()), 4 * x.detach())


def test_label_hands_real_tensors_to_the_hook_of_its_thread_only():
    x = torch.ones(3)
    assert label(x, "block_in") is x  # no hook: x itself
    seen, other = [], []
    with label_hook(lambda t, name: seen.append(name) or t * 2):
        assert torch.equal(label(x, "attn_out"), 2 * x)
        th = threading.Thread(target=lambda: other.append(label(x, "ffn_out")))
        th.start()
        th.join()
    assert seen == ["attn_out"] and other[0] is x
    assert label(x, "block_in") is x  # the hook is gone


# ------------------------------------------------------------------ driver
# At B4 S1024 the smoke model's activations pass AutoSwap's 1 MiB size
# threshold; 0.003 GiB (about 55% of the traced loss's 5.6 MiB peak load)
# names block_in.
DRIVER = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "1024",
          "--log-every", "1"]


# The three runs are compared bit for bit, so they run at one thread: ATen's
# vectorised CPU ``silu`` computes the elements past a chunk's last full
# vector by a scalar path with other bits, and splits its input into one
# chunk per thread of the team, so the SwiGLU's bits, and the second step's
# loss in its last ulps, follow the team size, and a call does not always
# get the team it asks for.
@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_train_main_executes_the_plan_at_a_limit(capsys, tmp_path, one_thread):
    ops.reset_launch_counts()
    plain = train.main(DRIVER)
    capsys.readouterr()
    cache = ["--hbm-limit-gb", "0.003", "--plan-cache", str(tmp_path)]
    first = train.main(DRIVER + cache)
    out1 = capsys.readouterr().out
    line = re.search(r"\[plan\] AutoSwap@0\.003GB: offload \[(.*?)\] .*", out1)
    assert line and line.group(1) == "'block_in'", out1
    assert first == plain                                    # bit for bit
    moved = 3 * 4 * 1024 * 64 * 4                           # layers x B x S x d x 4 B
    assert f"[offload] bytes a step to host [{moved}, {moved}], back [{moved}, {moved}]" in out1
    second = train.main(DRIVER + cache)
    out2 = capsys.readouterr().out
    assert "(restored from cache)" in out2 and line.group(0) in out2
    assert second == plain
    model = build_model(get_smoke_config(ARCH), "cpu")
    planner = train.step_planner(model, ARCH, 4, 1024, True, str(tmp_path))
    assert planner.from_cache
    assert planner.offload_plan(int(0.003 * 2**30)) == OffloadPlan(
        offload_names=["block_in"], predicted_savings=3 * 4 * 1024 * 64 * 4,
        transfer_bytes=2 * 3 * 4 * 1024 * 64 * 4)
    assert all(n == 0 for n in ops.launch_counts().values())  # plain versions only
