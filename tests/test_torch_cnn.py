"""The port's CNNs (``repro_torch.models.cnn``) against the JAX package's,
on the CPU: VGG and ResNet on CIFAR-10, the paper's own networks (§VI).

The same seeded numpy inputs and the reference's initial weights (carried
over by ``cnn_params_from_jax``: HWIO to OIHW) go through ``repro.models.cnn.CNN``
and the port's ``CNN``: logits, the loss, its gradient, the segmented-remat
loss and two SGD steps.  Then the port's ``cnn_trace`` against the trace
that ``benchmarks/common.py`` builds from the reference (built here the
same way, without importing ``benchmarks``): parameter bytes, peak load w,
SmartPool's chi/w and the traced FLOPs.  And the tracer's price of a
convolution's backward, node by node.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core.simulator import GTX_1080TI as R_GTX, assign_times as R_assign_times
from repro.core.smartpool import solve as R_solve
from repro.core.trace import trace_step_fn as R_trace_step_fn
from repro.models.cnn import CNN as RefCNN
from repro.models.cnn import _conv as ref_conv
from repro_torch.core import trace as P_trace
from repro_torch.core.smartpool import solve as P_solve
from repro_torch.models import CNN
from repro_torch.models.cnn import _conv, cnn_trace
from repro_torch.models.convert import cnn_params_from_jax
from repro_torch.tree import tree_leaves

# Relative to max|want| of each compared tensor.  In fp32, logits and the
# loss: tests/test_kernels.py's fp32 tolerance; the two sides differ by the
# order of fp32 sums in their convolutions (about 1e-6 here), and a wrong
# pad, layout or stride moves the logits by O(1).  Gradients and SGD steps
# are compared in fp64: a ReLU (or max-pool) input within fp32 rounding of
# 0 takes the other branch on one side, which moves fp32 gradients by
# orders more than TOL (chip_smoke.py's phase 13 prints resnet50's fp32
# gradients on the card 8.5e-3 of their largest entry from the CPU's, its
# fp64 ones 3e-15).  In fp64 such a branch needs an input within about
# 1e-15 of 0, and the two sides agree to within TOL64.
TOL = 2e-5
TOL64 = 1e-10
# (model, image side): VGG needs 32x32 for its five pools; resnet50 runs at
# 16x16 to keep the time down (its last stage is then 2x2).
MODELS = [("vgg11", 32), ("resnet18", 32), ("resnet50", 16)]


def _inputs(side: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, side, side, 3))                        # NHWC, fp64
    y = rng.integers(0, 10, size=2).astype(np.int32)
    return x, y


def _port_inputs(x, y, dtype=torch.float32):
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(dtype)
    return xt, torch.from_numpy(y.astype(np.int64))


def _close(got, want, tol: float) -> tuple[bool, float]:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float64)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-300)
    return err <= tol, err


def _port_tree(jax_tree, dtype):
    return cnn_params_from_jax(jax.tree.map(np.asarray, jax_tree), "cpu", dtype)


def _assert_trees_close(port_tree, jax_tree, what: str, tol: float):
    """``jax_tree`` (the reference's layout) carried into the port's, then
    leaf by leaf; ``None`` stays ``None`` on both sides."""
    want = _port_tree(jax_tree, torch.float64)
    got_leaves, want_leaves = tree_leaves(port_tree), tree_leaves(want)
    assert [g is None for g in got_leaves] == [w is None for w in want_leaves], what
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        if w is not None:
            ok, err = _close(g, w.numpy(), tol)
            assert ok, f"{what} leaf {i}: {err:.3e}"


@pytest.mark.parametrize("name,side", MODELS)
def test_cnn_matches_the_reference(name, side):
    ref, port = RefCNN(name), CNN(name)
    ref_params = ref.init(jax.random.PRNGKey(0))
    params = _port_tree(ref_params, torch.float32)
    x, y = _inputs(side)
    xt, yt = _port_inputs(x, y)
    x32 = x.astype(np.float32)

    ok, err = _close(port.apply(params, xt), ref.apply(ref_params, x32), TOL)
    assert ok, f"logits {err:.3e}"
    ok, err = _close(port.loss(params, xt, yt), ref.loss(ref_params, x32, y), TOL)
    assert ok, f"loss {err:.3e}"
    # Segmented remat recomputes the same ops: the port's own loss and
    # gradient, bit for bit.
    assert torch.equal(port.loss_remat(params, xt, yt), port.loss(params, xt, yt))
    for a, b in zip(tree_leaves(port.grads(params, xt, yt, remat=True)),
                    tree_leaves(port.grads(params, xt, yt))):
        assert (a is None and b is None) or torch.equal(a, b)

    with jax.enable_x64(True):
        ref_params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), ref_params)
        params = _port_tree(ref_params, torch.float64)
        xt, yt = _port_inputs(x, y, torch.float64)
        _assert_trees_close(port.grads(params, xt, yt), jax.grad(ref.loss)(ref_params, x, y),
                            "grad", TOL64)
        ok, err = _close(port.loss_remat(params, xt, yt), ref.loss_remat(ref_params, x, y),
                         TOL64)
        assert ok, f"loss_remat {err:.3e}"
        # Two SGD+momentum steps from zero momentum, on two batches.
        ref_m = jax.tree.map(jnp.zeros_like, ref_params)
        mom = port.zero_momentum(params)
        for step in range(2):
            x, y = _inputs(side, seed=1 + step)
            xt, yt = _port_inputs(x, y, torch.float64)
            ref_params, ref_m = ref.train_step(ref_params, ref_m, x, y)
            params, mom = port.train_step(params, mom, xt, yt)
        _assert_trees_close(params, ref_params, "params after two steps", TOL64)
        _assert_trees_close(mom, ref_m, "momentum after two steps", TOL64)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("side", [7, 8])
def test_conv_pads_as_xla_same(stride, k, side):
    rng = np.random.default_rng(side * 10 + k * 3 + stride)
    x = rng.standard_normal((2, side, side, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    want = np.asarray(ref_conv(x, w, stride)).transpose(0, 3, 1, 2)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got = _conv(xt, wt, stride)
    assert got.shape == want.shape
    ok, err = _close(got, want, TOL)
    assert ok, err
    if stride == 2 and k == 3 and side % 2 == 0:
        # XLA pads 0 before and 1 after here; PyTorch's symmetric padding=1
        # samples other positions.
        sym = F.conv2d(xt, wt, stride=2, padding=1)
        assert sym.shape == want.shape and not _close(sym, want, TOL)[0]


# ------------------------------------------------------------------ traces
def _ref_trace(name: str, batch: int, remat: bool):
    """``benchmarks/common.py``'s ``cnn_trace``, built here the same way."""
    cnn = RefCNN(name)
    params = jax.eval_shape(cnn.init, jax.random.PRNGKey(0))
    x, y = cnn.trace_inputs(batch)
    if remat:
        def step(p, m, xx, yy):
            g = jax.grad(lambda pp: cnn.loss_remat(pp, xx, yy))(p)
            upd = lambda pp, mm, gg: (pp - 0.01 * (0.9 * mm + gg), 0.9 * mm + gg)  # noqa: E731
            out = jax.tree.map(upd, p, m, g)
            two = lambda t: isinstance(t, tuple) and len(t) == 2  # noqa: E731
            return (jax.tree.map(lambda t: t[0], out, is_leaf=two),
                    jax.tree.map(lambda t: t[1], out, is_leaf=two))
    else:
        def step(p, m, xx, yy):
            return cnn.train_step(p, m, xx, yy)
    tr = R_trace_step_fn(step, params, params, x, y)
    R_assign_times(tr, R_GTX)
    return tr


def _flops(trace) -> float:
    return sum(f for f, _ in trace.op_costs.values())


# w (peak load) of the port's trace over the reference's.  The reference's
# ReLU keeps a bool mask (x > 0) beside each output for its backward, 1 B an
# element, which the port's ReLU does not (its backward reads the output);
# the port's max pool keeps its int64 indices, 8 B a pooled element, which
# the reference's does not; the port's labels are int64, 4 B a row more.
# At batch 4 the parameters, momentum and their updates set most of w.
OMEGA_RATIO = {("vgg11", 4): 0.9866, ("resnet18", 4): 0.9933, ("vgg16", 100): 0.9726}
# Traced FLOPs of the port over the reference's.  The port prices a
# convolution's input gradient at 2 |x| kh kw cout; the reference prices
# that conv_general_dilated eqn at 2 |x| kh kw cin, since the eqn carries
# the forward's kernel, whose last axis is cout.  Repriced the reference's
# way, the port's totals come within REPRICED_BAND of the reference's; the
# rest is elementwise ops and the port's stride-2 convolutions, which read
# an input padded to 33x33 where the reference pads inside the convolution.
FLOPS_RATIO = {("vgg11", 4): 1.0620, ("resnet18", 4): 1.0912, ("vgg16", 100): 1.0306}
FLOPS_BAND = 0.02
REPRICED_BAND = 0.015
CHI_GAP = 0.04  # SmartPool packs both within 4% of w (tests/test_torch_trace.py's)


def _conv_backward_flops_as_the_reference(node) -> float:
    """``_conv_backward_flops`` with grad_input at kh kw cin, the reference's
    reading of its eqn."""
    dy, x, w = (node.args[i].meta["val"] for i in range(3))
    mask = node.args[10]
    return (2.0 * x.numel() * math.prod(w.shape[1:]) * mask[0]
            + 2.0 * w.numel() * dy.shape[0] * math.prod(dy.shape[2:]) * mask[1]
            + float(dy.numel()) * mask[2])


@pytest.mark.parametrize("name,batch", sorted(OMEGA_RATIO))
def test_cnn_trace_matches_the_reference(name, batch, monkeypatch):
    ref, port = _ref_trace(name, batch, False), cnn_trace(name, batch)
    n_params = sum(1 for t in tree_leaves(CNN(name).init_shapes()) if t is not None)
    assert sum(v.size for v in port.variables[:n_params]) == \
        sum(v.size for v in ref.variables[:n_params])                 # parameter bytes
    ratio = port.peak_load() / ref.peak_load()
    want = OMEGA_RATIO[(name, batch)]
    assert want * 0.95 <= ratio <= want * 1.05, ratio
    chi_port = P_solve(port, "best_fit").footprint / port.peak_load()
    chi_ref = R_solve(ref, "best_fit").footprint / ref.peak_load()
    assert chi_port >= 1.0 and abs(chi_port - chi_ref) <= CHI_GAP, (chi_port, chi_ref)
    flops = _flops(port) / _flops(ref)
    want = FLOPS_RATIO[(name, batch)]
    assert abs(flops / want - 1) <= FLOPS_BAND, flops
    assert port.op_times is not None and port.op_times[-1] > 0    # priced under GTX_1080TI
    monkeypatch.setattr(P_trace, "_conv_backward_flops", _conv_backward_flops_as_the_reference)
    repriced = _flops(cnn_trace.__wrapped__(name, batch)) / _flops(ref)
    assert abs(repriced - 1) <= REPRICED_BAND, repriced


# vgg11 at batch 4 is left out: its w is set in the SGD update (parameters,
# momentum, gradients and the new trees), which remat does not touch.
@pytest.mark.parametrize("name,batch", [("resnet18", 4), ("vgg16", 100)])
def test_remat_trace_lowers_the_peak_load_in_both(name, batch):
    assert cnn_trace(name, batch, remat=True).peak_load() < cnn_trace(name, batch).peak_load()
    assert _ref_trace(name, batch, True).peak_load() < _ref_trace(name, batch, False).peak_load()


# ------------------------------------------------------- convolution backward
def _conv_backward_node(need_input: bool):
    x = torch.empty(2, 5, 8, 8, device="meta")
    w = torch.empty(6, 5, 3, 3, device="meta")

    def step(x, w):
        x = x.detach().requires_grad_(need_input)
        w = w.detach().requires_grad_(True)
        y = F.conv2d(x, w, stride=2, padding=1)
        return torch.autograd.grad(y.sum(), [x, w] if need_input else [w])

    gm = P_trace.capture_graph(step, x, w, device="cpu")
    nodes = [n for n in gm.graph.nodes if P_trace._qualified(n) == "aten::convolution_backward"]
    assert len(nodes) == 1
    return nodes[0]


@pytest.mark.parametrize("need_input", [True, False])
def test_convolution_backward_is_priced_as_two_products(need_input):
    node = _conv_backward_node(need_input)
    assert list(node.args[10]) == [need_input, True, False]          # output_mask
    dy = node.args[0].meta["val"]
    assert tuple(dy.shape) == (2, 6, 4, 4)
    grad_weight = 2.0 * (6 * 5 * 3 * 3) * (2 * 4 * 4)                # 2 |w| B H' W'
    grad_input = 2.0 * (2 * 5 * 8 * 8) * (3 * 3 * 6)                 # 2 |x| kh kw cout
    want = grad_weight + (grad_input if need_input else 0.0)
    flops, nbytes = P_trace._node_cost(node)
    assert flops == want
    assert nbytes > 0 and math.isfinite(nbytes)
