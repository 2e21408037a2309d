"""The flash gradient with a sliding window, on the CPU.

``flash_attention_bwd_plain`` with a window (the function the backward
kernels are held to on the card) against ``jax.vjp`` of the reference's
masked attention: ``repro.kernels.ref.mha_reference`` (the Pallas kernel's
oracle, fp32 softmax) over windows below a tile, across tiles and at least
S, ragged lengths, GQA groups of 1 and 5 and head dims 16, 64 and 128, and
the model's own ``mha_dense`` (``_causal_window_mask``) at hymba's smoke
widths; and against PyTorch autograd of ``flash_attention_plain`` with the
same window.  Then a Python twin of the CUDA kernels' tile ranges (the
q tiles a key tile's dK/dV block visits, the first key tile of a dQ block,
the ``edge`` predicate that turns the element masks on), held to a dense
enumeration of live pairs: every live pair lies in a visited tile, and a
step that masks nothing holds live pairs only.  Also the refusals that are
left (B2d: unmasked attention with a window, a window with Sq > Sk),
``ops.flash_mha`` routing a window's gradient to the plain version on CPU
tensors, and the tracer pricing a window's backward node.
Inputs are drawn with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ref as jax_ref
from repro.models.attention import mha_dense
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py's


def _draw(rng, shape, dtype):
    """numpy fp32 values, already rounded to ``dtype``, for both frameworks."""
    x = rng.standard_normal(shape, dtype=np.float32)
    return np.array(jnp.asarray(x, dtype).astype(jnp.float32))


def _torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _inputs(seed, B, S, H, KV, hd, dtype):
    rng = np.random.default_rng(seed)
    return (_draw(rng, (B, S, H, hd), dtype), _draw(rng, (B, S, KV, hd), dtype),
            _draw(rng, (B, S, KV, hd), dtype), _draw(rng, (B, S, H, hd), dtype))


def _plain_grads(q, k, v, do, dtype, window):
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    o, lse = flash_attention_plain(tq, tk, tv, window=window, return_lse=True)
    return flash_attention_bwd_plain(tq, tk, tv, o, _torch(do, dtype), lse, window=window)


# (B, S, H, KV, hd, window): windows below a 64-row tile, across tiles and
# at least S; S ragged to the tiles; groups of 1 and 5; head dims 16, 64, 128.
WINDOW_CASES = {
    "w1-hd16": (1, 70, 2, 2, 16, 1),
    "w5-below-tile-g5-hd64": (1, 96, 5, 1, 64, 5),
    "w16-ragged-g1-hd16": (2, 100, 4, 4, 16, 16),
    "w70-across-tiles-g5-hd64": (1, 200, 10, 2, 64, 70),
    "w129-ragged-hd128": (1, 150, 2, 1, 128, 129),
    "w-equals-S-hd64": (1, 77, 5, 5, 64, 77),
    "w-past-S-g5-hd128": (1, 65, 5, 1, 128, 500),
}


# bf16 inputs are held to the reference's vjp in fp32 on the same
# bf16-rounded values: the reference's own bf16 vjp rounds each query head's
# dk and dv to bf16 before it sums the group (the transpose of its
# ``astype`` after ``repeat``), which with 5 heads a group moved an element
# by up to 3.5e-2 at S 200, beyond the tolerance for reasons of its own.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_bwd_plain_matches_jax_vjp(case, dtype):
    """dq, dk, dv with a window against jax.vjp of the reference's masked
    attention, at the dtype's tolerance."""
    B, S, H, KV, hd, window = WINDOW_CASES[case]
    q, k, v, do = _inputs(1, B, S, H, KV, hd, dtype)
    _, vjp = jax.vjp(lambda q, k, v: jax_ref.mha_reference(q, k, v, causal=True, window=window),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    for g, w in zip(_plain_grads(q, k, v, do, dtype, window), want):
        assert g.dtype == getattr(torch, dtype)
        _close(g, w, TOL[dtype])


def test_window_bwd_plain_matches_the_models_mha_dense():
    """fp32 at hymba's smoke widths (4 heads on 2 kv heads of 16, window 16)
    at S 48, past the window: against jax.vjp of the model's ``mha_dense``,
    whose mask is ``_causal_window_mask``."""
    cfg = jax_smoke_config("hymba-1.5b")
    window = 16
    q, k, v, do = _inputs(2, 2, 48, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, "float32")
    _, vjp = jax.vjp(lambda q, k, v: mha_dense(q, k, v, cfg, causal=True, window=window),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    for g, w in zip(_plain_grads(q, k, v, do, "float32", window), want):
        _close(g, w, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [3, 40, 130])
def test_window_bwd_plain_matches_autograd_of_plain(window, dtype):
    q, k, v, do = (_torch(a, dtype) for a in _inputs(3, 2, 130, 5, 1, 32, dtype))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*leaves, window=window), leaves, do)
    o, lse = flash_attention_plain(q, k, v, window=window, return_lse=True)
    for g, w in zip(flash_attention_bwd_plain(q, k, v, o, do, lse, window=window), want):
        _close(g, w.float(), TOL[dtype])


def test_window_at_least_s_is_causal_bit_for_bit():
    q, k, v, do = (_torch(a, "float32") for a in _inputs(4, 1, 90, 4, 2, 16, "float32"))
    o, lse = flash_attention_plain(q, k, v, return_lse=True)
    causal = flash_attention_bwd_plain(q, k, v, o, do, lse)
    for window in (90, 1000):
        got = flash_attention_bwd_plain(q, k, v, o, do, lse, window=window)
        assert all(torch.equal(a, b) for a, b in zip(got, causal))


def test_flash_mha_takes_a_windows_gradient_through_the_operators():
    """``ops.flash_mha`` with a window and a gradient to take runs the LSE
    operator and ``repro_torch::flash_attention_bwd`` (the plain versions
    on CPU tensors, launching nothing), matching autograd of the plain
    forward."""
    ops.reset_launch_counts()
    q, k, v, do = (_torch(a, "float32") for a in _inputs(5, 1, 70, 4, 2, 16, "float32"))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_mha(*leaves, window=9), leaves, do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*ref, window=9), ref, do)
    for g, w in zip(got, want):
        _close(g, w, TOL["float32"])
    assert not any(ops.launch_counts().values())


# ------------------------------------------------------- the kernels' tiles
# A Python twin of the tile arithmetic in csrc/flash_attention_bwd_wgmma.cu
# (TR = 64 for key tiles, q tiles and both kernels' steps) and
# csrc/flash_attention_bwd.cu (`simt`: BQ = BK = 64; `mma`: a dK/dV block of
# KB = 64 keys stepping over QT = 32 q rows, a dQ block of QB = 64 rows
# stepping over KT = 32 keys), written as the sources compute it.  With
# ``causal=False`` (unmasked attention, never with a window) the blocks visit
# every tile and only the ragged edges mask (tests/test_torch_flash_unmasked_bwd.py).
def dkdv_q_steps(k0, kb, qt, Sq, window, causal=True):
    """The q rows a dK/dV block of keys [k0, k0 + kb) steps over, qt at a
    time: from k0's step (unmasked: from row 0), up to the last row that
    sees its last key."""
    q_end = min(Sq, k0 + kb - 1 + window) if window else Sq
    return range(k0 // qt * qt if causal else 0, q_end, qt)


def wgmma_dkdv_q_steps(k0, Sq, window, TR=64, causal=True):
    """The wgmma dK/dV kernel's form: n_q steps of TR rows from q_begin (k0,
    or 0 unmasked)."""
    q_begin = k0 if causal else 0
    q_end = min(Sq, k0 + TR - 1 + window) if window else Sq
    n_q = (q_end - q_begin + TR - 1) // TR if q_end > q_begin else 0
    return [q_begin + j * TR for j in range(n_q)]


def dq_k_steps(q0, qb, kt, Sq, Sk, window, causal=True):
    """The keys a dQ block of rows [q0, q0 + qb) steps over, kt at a time:
    from the step of its first row's first key up to its last row (unmasked:
    every key)."""
    k_end = min(Sk, q0 + qb, Sq) if causal else Sk
    k_begin = max(0, q0 - window + 1) // kt * kt if window else 0
    return range(k_begin, k_end, kt)


def wgmma_dq_k_steps(q0, Sq, Sk, window, TR=64, causal=True):
    """The wgmma dQ kernel's form: key tiles j0 .. n_k - 1."""
    k_end = min(Sk, q0 + TR, Sq) if causal else Sk
    j0 = max(0, q0 - window + 1) // TR if window else 0
    return [j * TR for j in range(j0, (k_end + TR - 1) // TR)]


def edge_dkdv(q0, k0, Sq, Sk, window, TR=64, causal=True):
    return ((causal and q0 < k0 + TR) or q0 + TR > Sq or k0 + TR > Sk
            or bool(window and q0 + TR - 1 - k0 >= window))


def edge_dq(q0, k0, Sq, Sk, window, TR=64, causal=True):
    return ((causal and k0 + TR > q0) or k0 + TR > Sk or q0 + TR > Sq
            or bool(window and q0 + TR - 1 - k0 >= window))


def _live(Sq, Sk, window, causal=True):
    off = np.arange(Sq)[:, None] - np.arange(Sk)[None, :]
    return ((off >= 0) if causal else np.ones(off.shape, bool)) & \
        (off < window if window else True)


def _blocks(S, t):
    return range(0, S, t)


TILE_LENGTHS = [(1, 1), (37, 37), (64, 64), (65, 65), (100, 100), (200, 200), (257, 257),
                (100, 300)]  # the last: Sq < Sk, which a window allows
TILE_WINDOWS = [1, 2, 15, 16, 31, 63, 64, 65, 100, 128, 199, 256, 1000, None]


@pytest.mark.parametrize("Sq,Sk", TILE_LENGTHS)
def test_tile_ranges_cover_every_live_pair(Sq, Sk):
    """Each kernel family's visited (q step, key block) and (q block, key
    step) pairs cover every live pair, for windows from 1 to past S."""
    families = {"wgmma": (64, 64, 64, 64), "simt": (64, 64, 64, 64), "mma": (64, 32, 64, 32)}
    for window in TILE_WINDOWS:
        live = _live(Sq, Sk, window)
        for name, (kb, qt, qb, kt) in families.items():
            seen = np.zeros_like(live)
            for k0 in _blocks(Sk, kb):
                steps = (wgmma_dkdv_q_steps(k0, Sq, window) if name == "wgmma"
                         else dkdv_q_steps(k0, kb, qt, Sq, window))
                for q0 in steps:
                    seen[q0:q0 + qt, k0:k0 + kb] = True
            assert not (live & ~seen).any(), (name, "dK/dV", window)
            seen[:] = False
            for q0 in _blocks(Sq, qb):
                steps = (wgmma_dq_k_steps(q0, Sq, Sk, window) if name == "wgmma"
                         else dq_k_steps(q0, qb, kt, Sq, Sk, window))
                for k0 in steps:
                    seen[q0:q0 + qb, k0:k0 + kt] = True
            assert not (live & ~seen).any(), (name, "dQ", window)
            if name == "wgmma":  # the loop forms of the sources agree with each other
                assert all(list(wgmma_dkdv_q_steps(k0, Sq, window))
                           == list(dkdv_q_steps(k0, 64, 64, Sq, window))
                           for k0 in _blocks(Sk, 64))
                assert all(wgmma_dq_k_steps(q0, Sq, Sk, window)
                           == list(dq_k_steps(q0, 64, 64, Sq, Sk, window))
                           for q0 in _blocks(Sq, 64))


@pytest.mark.parametrize("Sq,Sk", TILE_LENGTHS)
def test_wgmma_steps_without_edge_hold_live_pairs_only(Sq, Sk):
    """The wgmma kernels skip the element masks on a step whose ``edge`` is
    false: every pair of such a step must be in bounds and live.  And the
    window's ranges never add a step that the causal kernel would not run."""
    for window in TILE_WINDOWS:
        live = _live(Sq, Sk, window)
        for k0 in _blocks(Sk, 64):
            steps = wgmma_dkdv_q_steps(k0, Sq, window)
            assert set(steps) <= set(wgmma_dkdv_q_steps(k0, Sq, None))
            for q0 in steps:
                if not edge_dkdv(q0, k0, Sq, Sk, window):
                    assert q0 + 64 <= Sq and k0 + 64 <= Sk
                    assert live[q0:q0 + 64, k0:k0 + 64].all(), (window, q0, k0)
        for q0 in _blocks(Sq, 64):
            steps = wgmma_dq_k_steps(q0, Sq, Sk, window)
            assert set(steps) <= set(wgmma_dq_k_steps(q0, Sq, Sk, None))
            for k0 in steps:
                if not edge_dq(q0, k0, Sq, Sk, window):
                    assert q0 + 64 <= Sq and k0 + 64 <= Sk
                    assert live[q0:q0 + 64, k0:k0 + 64].all(), (window, q0, k0)


def test_a_window_at_least_s_runs_the_causal_steps():
    """Where the window reaches past every row (W >= Sq), both wgmma kernels
    visit exactly the causal steps, and a step's mask only ever zeroes
    pairs the causal mask zeroes: the kernel's result is the causal one,
    bit for bit, which ``chip_smoke.py`` phase 19a checks on the card."""
    for S in (64, 100, 1000, 2048):
        for window in (S, S + 1, 4096):
            for k0 in _blocks(S, 64):
                assert wgmma_dkdv_q_steps(k0, S, window) == wgmma_dkdv_q_steps(k0, S, None)
            for q0 in _blocks(S, 64):
                assert wgmma_dq_k_steps(q0, S, S, window) == wgmma_dq_k_steps(q0, S, S, None)
            assert (_live(S, S, window) == _live(S, S, None)).all()


# ------------------------------------------------------------ refusals, tracer
def test_refusals_left_name_b2d():
    """What the gradient does not take raises before any code runs, on the
    CPU as on the card: unmasked attention with a window, and a window with
    Sq > Sk.  A softcap and head dim 256 are taken since their kernels
    landed (tests/test_torch_flash_gemma_bwd.py), as is unmasked attention
    without a window (tests/test_torch_flash_unmasked_bwd.py)."""
    refused = [((1, 8, 2, 16), 8, dict(causal=False, window=4)),
               ((1, 8, 2, 16), 4, dict(window=4))]
    taken = [((1, 8, 2, 16), 8, dict(softcap=30.0)), ((1, 8, 2, 256), 8, {}),
             ((1, 8, 2, 256), 8, dict(window=4, softcap=50.0))]
    for qshape, sk, kw in refused + taken:
        q = torch.zeros(qshape)
        k = torch.zeros(qshape[0], sk, qshape[2], qshape[3])
        lse = torch.zeros(qshape[0], qshape[2], qshape[1])
        if (qshape, sk, kw) in taken:
            flash_attention_bwd_plain(q, k, k, q, q, lse, **kw)
            ops.flash_mha(q.clone().requires_grad_(), k, k, **kw).sum().backward()
            continue
        with pytest.raises(NotImplementedError, match="B2d"):
            flash_attention_bwd_plain(q, k, k, q, q, lse, **kw)
        with pytest.raises(NotImplementedError, match="B2d"):
            ops.flash_mha(q.clone().requires_grad_(), k, k, **kw)


@pytest.mark.parametrize("window", [None, 7, 24, 100])
def test_tracer_prices_the_backward_by_its_window(window):
    """A traced ``flash_mha`` gradient: the backward node is priced at
    10 B H hd times the live pairs under its own window, the forward at 4."""
    import repro_torch.core.trace as P

    B, S, H, KV, hd = 2, 40, 4, 2, 16
    shapes = [(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)]

    def step(q, k, v):
        leaves = [t.requires_grad_(True) for t in (q, k, v)]
        out = ops.flash_mha(*leaves, window=window)
        return torch.autograd.grad(out.sum(), leaves)

    gm = P.capture_graph(step, *(torch.empty(s, device="meta") for s in shapes))
    nodes = {str(n.target): n for n in gm.graph.nodes if n.op == "call_function"}
    bwd = nodes["repro_torch.flash_attention_bwd.default"]
    fwd = nodes["repro_torch.flash_attention_lse.default"]
    pairs = P._live_pairs(S, S, True, window)
    assert pairs == int(_live(S, S, window).sum())
    assert P._node_cost(bwd)[0] == 10 * B * H * hd * pairs
    assert P._node_cost(fwd)[0] == 4 * B * H * hd * pairs
