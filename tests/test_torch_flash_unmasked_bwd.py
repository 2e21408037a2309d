"""The flash gradient of unmasked attention, on the CPU.

``flash_attention_bwd_plain(causal=False)`` (the function the backward
kernels are held to on the card) against ``jax.vjp`` of the reference's
unmasked attention: ``repro.kernels.ref.mha_reference(causal=False)`` (the
Pallas kernel's oracle) at Sq = Sk ragged to the tiles, Sq < Sk and Sq > Sk,
GQA groups of 1 and 5 and head dims 16, 64 and 128, and the model's own
``_sdpa`` with no mask, as whisper's cross attention calls it, at the smoke
config's widths; and against PyTorch autograd of
``flash_attention_plain(causal=False)``.  Then the Python twin of the CUDA
kernels' tile ranges and ``edge`` predicate
(``tests/test_torch_flash_window_bwd.py``), given ``causal=False``, held to
a dense enumeration of the pairs: every pair lies in a visited tile, and a
step that masks nothing lies inside both lengths.  Also ``ops.flash_mha``
taking an unmasked gradient through the operators on CPU tensors, and the
tracer pricing the unmasked backward node at Sq Sk pairs.  Inputs are
drawn with numpy from seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ref as jax_ref
from repro.models.attention import _sdpa
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain)
from test_torch_flash_window_bwd import (_live, dkdv_q_steps, dq_k_steps, edge_dkdv, edge_dq,
                                         wgmma_dkdv_q_steps, wgmma_dq_k_steps)

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


def _inputs(seed, B, Sq, Sk, H, KV, hd, dtype):
    rng = np.random.default_rng(seed)
    return (_draw(rng, (B, Sq, H, hd), dtype), _draw(rng, (B, Sk, KV, hd), dtype),
            _draw(rng, (B, Sk, KV, hd), dtype), _draw(rng, (B, Sq, H, hd), dtype))


def _plain_grads(q, k, v, do, dtype):
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    o, lse = flash_attention_plain(tq, tk, tv, causal=False, return_lse=True)
    return flash_attention_bwd_plain(tq, tk, tv, o, _torch(do, dtype), lse, causal=False)


# (B, Sq, Sk, H, KV, hd): Sq = Sk ragged to the 64-row tiles, Sq < Sk (a
# decoder's queries against an encoder's keys) and Sq > Sk; groups of 1 and
# 5; head dims 16, 64 and 128.
UNMASKED_CASES = {
    "s150-g1-hd64": (1, 150, 150, 2, 2, 64),
    "s150-g5-hd16": (2, 150, 150, 5, 1, 16),
    "sq28-sk150-g5-hd16": (2, 28, 150, 5, 1, 16),
    "sq28-sk150-g1-hd128": (1, 28, 150, 4, 4, 128),
    "sq150-sk28-g1-hd128": (1, 150, 28, 2, 2, 128),
    "sq150-sk28-g5-hd64": (1, 150, 28, 10, 2, 64),
}


# bf16 inputs are held to the reference's vjp in fp32 on the same
# bf16-rounded values, as tests/test_torch_flash_window_bwd.py holds the
# window's: the reference's own bf16 vjp rounds each query head's dk and dv
# to bf16 before it sums the group.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(UNMASKED_CASES))
def test_unmasked_bwd_plain_matches_jax_vjp(case, dtype):
    """dq, dk, dv of unmasked attention against jax.vjp of the reference's
    ``mha_reference(causal=False)``, at the dtype's tolerance."""
    B, Sq, Sk, H, KV, hd = UNMASKED_CASES[case]
    q, k, v, do = _inputs(1, B, Sq, Sk, H, KV, hd, dtype)
    _, vjp = jax.vjp(lambda q, k, v: jax_ref.mha_reference(q, k, v, causal=False),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    for g, w, t in zip(_plain_grads(q, k, v, do, dtype), want, (q, k, v)):
        assert g.dtype == getattr(torch, dtype) and g.shape == t.shape
        _close(g, w, TOL[dtype])


@pytest.mark.parametrize("Sq,Sk", [(12, 24), (24, 24), (30, 7)])
def test_unmasked_bwd_plain_matches_the_models_sdpa(Sq, Sk):
    """fp32 at whisper's smoke widths (4 heads of 16, scale hd^-0.5): against
    jax.vjp of the model's ``_sdpa(q, k, v, None, cfg)``, the reference's
    cross attention (decoder queries against the encoder's 24 frames), its
    encoder's self attention at Sq = Sk, and Sq > Sk."""
    cfg = jax_smoke_config("whisper-large-v3")
    q, k, v, do = _inputs(2, 2, Sq, Sk, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                          "float32")
    _, vjp = jax.vjp(lambda q, k, v: _sdpa(q, k, v, None, cfg),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    for g, w in zip(_plain_grads(q, k, v, do, "float32"), want):
        _close(g, w, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk", [(130, 130), (40, 130), (130, 40)])
def test_unmasked_bwd_plain_matches_autograd_of_plain(Sq, Sk, dtype):
    q, k, v, do = (_torch(a, dtype) for a in _inputs(3, 2, Sq, Sk, 5, 1, 32, dtype))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*leaves, causal=False), leaves, do)
    o, lse = flash_attention_plain(q, k, v, causal=False, return_lse=True)
    for g, w in zip(flash_attention_bwd_plain(q, k, v, o, do, lse, causal=False), want):
        _close(g, w.float(), TOL[dtype])


def test_flash_mha_takes_an_unmasked_gradient_through_the_operators():
    """``ops.flash_mha(causal=False)`` with a gradient to take, Sq != Sk, runs
    the LSE operator and ``repro_torch::flash_attention_bwd`` (the plain
    versions on CPU tensors, launching nothing), matching autograd of the
    plain forward."""
    ops.reset_launch_counts()
    q, k, v, do = (_torch(a, "float32") for a in _inputs(5, 1, 20, 70, 4, 2, 16, "float32"))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_mha(*leaves, causal=False), leaves, do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*ref, causal=False), ref, do)
    for g, w in zip(got, want):
        _close(g, w, TOL["float32"])
    assert not any(ops.launch_counts().values())


# ------------------------------------------------------- the kernels' tiles
UNMASKED_LENGTHS = [(1, 1), (37, 37), (64, 64), (65, 65), (150, 28), (28, 150), (128, 1500),
                    (448, 1500), (1500, 1500), (700, 300)]


def _blocks(S, t):
    return range(0, S, t)


@pytest.mark.parametrize("Sq,Sk", UNMASKED_LENGTHS)
def test_unmasked_tile_ranges_cover_every_pair(Sq, Sk):
    """Unmasked, each kernel family's visited (q step, key block) and (q
    block, key step) pairs cover all Sq x Sk pairs; the wgmma blocks visit
    every tile exactly once, so ceil(Sq / 64) q steps a dK/dV block of a
    query head and ceil(Sk / 64) key steps a dQ block."""
    live = _live(Sq, Sk, None, causal=False)
    assert live.all()
    families = {"wgmma": (64, 64, 64, 64), "simt": (64, 64, 64, 64), "mma": (64, 32, 64, 32)}
    for name, (kb, qt, qb, kt) in families.items():
        seen = np.zeros_like(live)
        for k0 in _blocks(Sk, kb):
            steps = (wgmma_dkdv_q_steps(k0, Sq, None, causal=False) if name == "wgmma"
                     else dkdv_q_steps(k0, kb, qt, Sq, None, causal=False))
            assert list(steps) == list(range(0, Sq, qt)), (name, k0)
            for q0 in steps:
                seen[q0:q0 + qt, k0:k0 + kb] = True
        assert seen.all(), (name, "dK/dV")
        seen[:] = False
        for q0 in _blocks(Sq, qb):
            steps = (wgmma_dq_k_steps(q0, Sq, Sk, None, causal=False) if name == "wgmma"
                     else dq_k_steps(q0, qb, kt, Sq, Sk, None, causal=False))
            assert list(steps) == list(range(0, Sk, kt)), (name, q0)
            for k0 in steps:
                seen[q0:q0 + qb, k0:k0 + kt] = True
        assert seen.all(), (name, "dQ")


@pytest.mark.parametrize("Sq,Sk", UNMASKED_LENGTHS)
def test_unmasked_edge_is_only_the_ragged_tiles(Sq, Sk):
    """Unmasked, the wgmma kernels turn the element masks on exactly on a
    step whose rows run past Sq or whose keys run past Sk: such a step's
    padded rows load zeros and an LSE of 0 (so P = 1 before the mask) and
    must be masked, and every other step holds in-bounds pairs only, none
    of them masked.  At whisper's S 1500 (23 full tiles and one of 28)
    that is the last tile's row and column of steps."""
    for k0 in _blocks(Sk, 64):
        for q0 in wgmma_dkdv_q_steps(k0, Sq, None, causal=False):
            ragged = q0 + 64 > Sq or k0 + 64 > Sk
            assert edge_dkdv(q0, k0, Sq, Sk, None, causal=False) == ragged
            assert edge_dq(q0, k0, Sq, Sk, None, causal=False) == ragged
    if Sq == Sk == 1500:
        tiles = -(-Sq // 64)
        masked = sum(edge_dq(q0, k0, Sq, Sk, None, causal=False)
                     for q0 in _blocks(Sq, 64) for k0 in _blocks(Sk, 64))
        assert masked == 2 * tiles - 1


def test_the_causal_twin_is_unchanged_by_the_flag():
    """``causal=True`` (the default) gives the causal kernels' ranges and
    predicates, which tests/test_torch_flash_window_bwd.py holds: the flag
    adds nothing to the causal instantiations."""
    for Sq, Sk in ((100, 100), (64, 300), (300, 64)):
        for k0 in _blocks(Sk, 64):
            assert wgmma_dkdv_q_steps(k0, Sq, None) == \
                [q0 for q0 in range(k0, Sq, 64)]
        for q0 in _blocks(Sq, 64):
            assert wgmma_dq_k_steps(q0, Sq, Sk, None) == \
                list(range(0, min(Sk, q0 + 64, Sq), 64))
            for k0 in _blocks(Sk, 64):
                assert edge_dq(q0, k0, Sq, Sk, None) == (
                    k0 + 64 > q0 or k0 + 64 > Sk or q0 + 64 > Sq)


# ------------------------------------------------------------------ tracer
@pytest.mark.parametrize("Sq,Sk", [(24, 24), (9, 24), (24, 9)])
def test_tracer_prices_the_unmasked_backward_at_sq_sk_pairs(Sq, Sk):
    """A traced ``flash_mha(causal=False)`` gradient: the backward node is
    priced at 10 B H hd Sq Sk (every pair live), the forward at 4 B H hd Sq
    Sk."""
    import repro_torch.core.trace as P

    B, H, KV, hd = 2, 4, 2, 16
    shapes = [(B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)]

    def step(q, k, v):
        leaves = [t.requires_grad_(True) for t in (q, k, v)]
        out = ops.flash_mha(*leaves, causal=False)
        return torch.autograd.grad(out.sum(), leaves)

    gm = P.capture_graph(step, *(torch.empty(s, device="meta") for s in shapes))
    nodes = {str(n.target): n for n in gm.graph.nodes if n.op == "call_function"}
    bwd = nodes["repro_torch.flash_attention_bwd.default"]
    fwd = nodes["repro_torch.flash_attention_lse.default"]
    assert P._live_pairs(Sq, Sk, False, None) == Sq * Sk
    assert P._node_cost(bwd)[0] == 10 * B * H * hd * Sq * Sk
    assert P._node_cost(fwd)[0] == 4 * B * H * hd * Sq * Sk
