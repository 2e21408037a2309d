"""The flash gradient at head dim 256 and with a tanh softcap, on the CPU.

``flash_attention_bwd_plain`` (the function the backward kernels are held
to on the card) against ``jax.vjp`` of the reference's attention,
``repro.kernels.ref.mha_reference`` (the Pallas kernel's oracle: fp32
scores, scaled, then capped as ``softcap * tanh(s / softcap)``), at head dim
256 with and without a softcap and at head dims 16 and 64 with one: causal,
with a window, unmasked with Sq != Sk, GQA groups and ragged lengths; and
against PyTorch autograd of ``flash_attention_plain``.  A case where the
cap bites (scores of several caps) shows that a gradient without the
softcap's factor 1 - t^2 would fail the same tolerance.  Then Python twins
of the kernels' new tile arithmetic held to a dense enumeration of live
pairs: the ``simt`` kernels' 32-row tiles above head dim 128, and the
``wgmma`` dK/dV kernel's split at head dim 256, where both warpgroups take
every step and each sums its own half of the columns.  Also the gemmas'
layouts through ``ops.flash_mha`` and the operators on the CPU, launching
nothing.  Inputs are drawn with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (block_shape, bwd_variant, check_bwd_supported,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py's


def _draw(rng, shape, dtype, gain=1.0):
    """numpy fp32 values times ``gain``, already rounded to ``dtype``, for
    both frameworks."""
    x = gain * rng.standard_normal(shape, dtype=np.float32)
    return np.array(jnp.asarray(x, dtype).astype(jnp.float32))


def _torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _excess(got, want, tol) -> float:
    """max(|got - want| - tol |want|): at most tol where allclose holds."""
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    return float((np.abs(g - w) - tol * np.abs(w)).max())


def _inputs(seed, B, Sq, Sk, H, KV, hd, dtype, q_gain=1.0):
    rng = np.random.default_rng(seed)
    return (_draw(rng, (B, Sq, H, hd), dtype, q_gain), _draw(rng, (B, Sk, KV, hd), dtype),
            _draw(rng, (B, Sk, KV, hd), dtype), _draw(rng, (B, Sq, H, hd), dtype))


def _plain_grads(q, k, v, do, dtype, **kw):
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    o, lse = flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    return flash_attention_bwd_plain(tq, tk, tv, o, _torch(do, dtype), lse, **kw)


def _jax_grads(q, k, v, do, **kw):
    _, vjp = jax.vjp(lambda q, k, v: jax_ref.mha_reference(q, k, v, **kw),
                     *(jnp.asarray(a) for a in (q, k, v)))
    return vjp(jnp.asarray(do))


# (B, Sq, Sk, H, KV, hd, attention keywords): head dim 256 as the gemmas run
# it (gemma2's softcap 50 and scale 224^-0.5), and head dims 16 and 64 with a
# softcap; causal, a window below, across and past the 64-row tiles,
# unmasked with Sq != Sk; groups of 1, 2 and 5; lengths ragged to the tiles.
CASES = {
    "hd256-causal-g2": (1, 70, 70, 4, 2, 256, dict()),
    "hd256-window-g2-ragged": (1, 100, 100, 4, 2, 256, dict(window=33)),
    "hd256-unmasked-sq-lt-sk": (1, 40, 90, 2, 1, 256, dict(causal=False)),
    "hd256-unmasked-sq-gt-sk": (1, 90, 33, 2, 2, 256, dict(causal=False)),
    "hd256-gemma2-softcap": (1, 77, 77, 4, 2, 256, dict(softcap=50.0, scale=224.0**-0.5)),
    "hd256-gemma2-window-softcap": (1, 130, 130, 4, 2, 256,
                                    dict(window=48, softcap=50.0, scale=224.0**-0.5)),
    "hd256-unmasked-softcap": (1, 50, 70, 2, 1, 256, dict(causal=False, softcap=20.0)),
    "hd16-softcap-g5": (2, 65, 65, 5, 1, 16, dict(softcap=3.0)),
    "hd16-window-softcap": (1, 100, 100, 4, 4, 16, dict(window=16, softcap=5.0)),
    "hd64-softcap-ragged": (1, 129, 129, 4, 2, 64, dict(softcap=30.0)),
    "hd64-unmasked-softcap": (1, 60, 100, 4, 2, 64, dict(causal=False, softcap=10.0)),
}


# bf16 inputs are held to the reference's vjp in fp32 on the same
# bf16-rounded values: the reference's own bf16 vjp rounds each query head's
# dk and dv before it sums the group (tests/test_torch_flash_window_bwd.py).
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_bwd_plain_matches_jax_vjp(case, dtype):
    """dq, dk, dv against jax.vjp of the reference's attention with the same
    mask, softcap and scale, at the dtype's tolerance."""
    B, Sq, Sk, H, KV, hd, kw = CASES[case]
    q, k, v, do = _inputs(1, B, Sq, Sk, H, KV, hd, dtype)
    want = _jax_grads(q, k, v, do, **{"causal": True, **kw})
    for g, w in zip(_plain_grads(q, k, v, do, dtype, **kw), want):
        assert g.dtype == getattr(torch, dtype)
        _close(g, w, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,kw", [(256, dict()), (256, dict(softcap=50.0, window=40)),
                                   (32, dict(softcap=4.0)),
                                   (256, dict(causal=False, softcap=8.0))])
def test_bwd_plain_matches_autograd_of_plain(hd, kw, dtype):
    """The closed form against autograd through the plain forward's own
    tiles, softcap and mask."""
    q, k, v, do = (_torch(a, dtype) for a in _inputs(3, 1, 75, 75, 4, 2, hd, dtype))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*leaves, **kw), leaves, do)
    o, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    for g, w in zip(flash_attention_bwd_plain(q, k, v, o, do, lse, **kw), want):
        _close(g, w.float(), TOL[dtype])


def _bwd_without_the_slope(q, k, v, o, do, lse, softcap, scale):
    """The gradient with the softcap's P but without its factor 1 - t^2: the
    fault a kernel that dropped the factor would have (causal, fp32)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    dof = do.float().transpose(1, 2)
    s = softcap * torch.tanh(qf @ kf.transpose(-1, -2) * scale / softcap)
    live = torch.ones(S, S, dtype=torch.bool).tril()
    p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - (dof * o.float().transpose(1, 2)).sum(-1, True))
    dq = ds @ kf * scale
    dk = (ds.transpose(-1, -2) @ qf * scale).view(B, -1, G, S, hd).sum(2)
    dv = (p.transpose(-1, -2) @ dof).view(B, -1, G, S, hd).sum(2)
    return tuple(t.transpose(1, 2) for t in (dq, dk, dv))


@pytest.mark.parametrize("hd,softcap,q_gain", [(256, 2.0, 4.0), (64, 50.0, 60.0)])
def test_a_cap_that_bites_needs_the_slope(hd, softcap, q_gain):
    """Scores of several caps (q scaled up, or a cap of 2): the plain gradient
    matches the reference's vjp at bf16's tolerance, while the same
    gradient without 1 - t^2 misses it by more than ten times that
    tolerance.  (With unit-normal inputs and a cap of 50, 1 - t^2 is about 1
    and a gradient without it would pass.)"""
    tol = TOL["bfloat16"]
    q, k, v, do = _inputs(7, 1, 96, 96, 4, 2, hd, "float32", q_gain)
    kw = dict(softcap=softcap, scale=hd**-0.5)
    want = _jax_grads(q, k, v, do, causal=True, **kw)
    tq, tk, tv, tdo = (_torch(a, "float32") for a in (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    got = flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse, **kw)
    assert max(_excess(g, w, tol) for g, w in zip(got, want)) <= tol
    faulty = _bwd_without_the_slope(tq, tk, tv, o, tdo, lse, softcap, hd**-0.5)
    # dv does not see the factor; dq and dk do
    assert min(_excess(g, w, tol) for g, w in zip(faulty[:2], want[:2])) > 10 * tol


def test_flash_mha_takes_the_gemmas_gradients_through_the_operators():
    """``ops.flash_mha`` at the gemmas' layouts, cut small (head dim 256;
    gemma3's window with GQA, gemma2's window, softcap 50 and scale 224^-0.5),
    with a gradient to take: the LSE operator and
    ``repro_torch::flash_attention_bwd`` run their plain versions on CPU
    tensors, launching nothing, and match autograd of the plain forward."""
    ops.reset_launch_counts()
    for kw in (dict(window=24), dict(window=24, softcap=50.0, scale=224.0**-0.5),
               dict(softcap=50.0, scale=224.0**-0.5)):
        q, k, v, do = (_torch(a, "float32") for a in _inputs(5, 1, 70, 70, 4, 2, 256, "float32"))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(ops.flash_mha(*leaves, **kw), leaves, do)
        ref = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(flash_attention_plain(*ref, **kw), ref, do)
        for g, w in zip(got, want):
            _close(g, w, TOL["float32"])
    assert not any(ops.launch_counts().values())


def test_the_gradient_takes_hd256_and_a_softcap():
    """``check_bwd_supported`` takes head dims up to 256 and a softcap with
    every mask it takes, and still refuses, naming B2d, unmasked attention
    with a window and a window with Sq > Sk; ``bwd_variant`` sends bf16 at
    head dim 256 to ``wgmma`` and fp32 there to ``simt``."""
    for causal, window, softcap, sq, sk in ((True, None, 50.0, 8, 8), (True, 4, 50.0, 8, 8),
                                            (False, None, 50.0, 3, 8), (True, None, None, 8, 8)):
        check_bwd_supported(causal, window, softcap, 256, sq, sk)
    for causal, window, sq, sk in ((False, 4, 8, 8), (True, 4, 8, 4)):
        with pytest.raises(NotImplementedError, match="B2d"):
            check_bwd_supported(causal, window, 50.0, 256, sq, sk)
    for dtype, want in ((torch.bfloat16, "wgmma"), (torch.float32, "simt")):
        o = torch.zeros(1, 4, 2, 256, dtype=dtype)
        assert bwd_variant(o, o) == want


# ------------------------------------------------------- the kernels' tiles
# Python twins of the tile arithmetic in csrc/flash_attention_bwd.cu
# (`simt`: tiles of BT = 64 rows and keys up to head dim 128, 32 above) and
# csrc/flash_attention_bwd_wgmma.cu (TR = 64; up to head dim 128 the dK/dV
# block deals its steps to its two warpgroups in turn, each summing every
# column; at 256 (SPLIT) both take every step, each summing its own 128).
def simt_tile(hd: int) -> int:
    return 64 if hd <= 128 else 32


def simt_dkdv_q_steps(k0, bt, Sq, window, causal=True):
    q_end = min(Sq, k0 + bt - 1 + window) if window else Sq
    return range(k0 // bt * bt if causal else 0, q_end, bt)


def simt_dq_k_steps(q0, bt, Sq, Sk, window, causal=True):
    k_end = min(Sk, q0 + bt, Sq) if causal else Sk
    k_begin = max(0, q0 - window + 1) // bt * bt if window else 0
    return range(k_begin, k_end, bt)


def wgmma_dkdv_work(k0, Sq, hd, window, causal=True, TR=64):
    """[(warpgroup, q0, first column, columns)] that the dK/dV block of keys
    [k0, k0 + 64) sums, in the kernel's order: its n_q q tiles of each of
    the group's heads (one head here), dealt as the kernel deals them."""
    q_begin = k0 if causal else 0
    q_end = min(Sq, k0 + TR - 1 + window) if window else Sq
    n_steps = (q_end - q_begin + TR - 1) // TR if q_end > q_begin else 0
    split = hd > 128
    cw = hd // 2 if split else hd
    work = []
    for wg in (0, 1):
        my_steps = n_steps if split else (n_steps - wg + 1) // 2
        for t in range(my_steps):
            j = t if split else wg + 2 * t
            work.append((wg, q_begin + j * TR, wg * cw if split else 0, cw))
    return work


def _live(Sq, Sk, window, causal=True):
    off = np.arange(Sq)[:, None] - np.arange(Sk)[None, :]
    return ((off >= 0) if causal else np.ones(off.shape, bool)) & \
        (off < window if window else True)


TILE_LENGTHS = [(1, 1), (31, 31), (32, 32), (33, 33), (100, 100), (257, 257), (100, 300)]
TILE_WINDOWS = [1, 15, 31, 32, 33, 64, 100, 1000, None]


@pytest.mark.parametrize("Sq,Sk", TILE_LENGTHS)
def test_simt_tiles_above_hd128_cover_every_live_pair(Sq, Sk):
    """The ``simt`` kernels at head dim 256 (32-row tiles; the tile follows
    the forward's ``block_shape``): every live pair lies in a visited
    (q step, key block) of the dK/dV kernel and (q block, key step) of the
    dQ kernel, for windows from 1 to past S, causal and (without a window,
    at any Sq and Sk) unmasked."""
    bt = simt_tile(256)
    assert (bt, bt) == block_shape(torch.float32, 256) and simt_tile(128) == 64
    for causal, windows in ((True, TILE_WINDOWS), (False, [None])):
        for window in windows:
            if causal and window and Sq > Sk:
                continue
            live = _live(Sq, Sk, window, causal)
            seen = np.zeros_like(live)
            for k0 in range(0, Sk, bt):
                for q0 in simt_dkdv_q_steps(k0, bt, Sq, window, causal):
                    seen[q0:q0 + bt, k0:k0 + bt] = True
            assert not (live & ~seen).any(), ("dK/dV", causal, window)
            seen[:] = False
            for q0 in range(0, Sq, bt):
                for k0 in simt_dq_k_steps(q0, bt, Sq, Sk, window, causal):
                    seen[q0:q0 + bt, k0:k0 + bt] = True
            assert not (live & ~seen).any(), ("dQ", causal, window)


@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("Sq,Sk", [(64, 64), (100, 100), (257, 257), (70, 300)])
def test_wgmma_dkdv_sums_every_live_pair_and_column_once(hd, Sq, Sk):
    """Each (live pair, column of dK and dV) is summed by exactly one
    warpgroup of its key block: up to head dim 128 by the one its step was
    dealt to, over every column; at 256 by each warpgroup over its own half,
    both taking every step."""
    for causal, windows in ((True, TILE_WINDOWS), (False, [None])):
        for window in windows:
            if causal and window and Sq > Sk:
                continue
            live = _live(Sq, Sk, window, causal)
            count = np.zeros((Sq, Sk, hd // 64), np.int64)  # columns in 64-wide panels
            for k0 in range(0, Sk, 64):
                for wg, q0, c0, cw in wgmma_dkdv_work(k0, Sq, hd, window, causal):
                    count[q0:q0 + 64, k0:k0 + 64, c0 // 64:(c0 + cw) // 64] += 1
            assert (count[live] == 1).all(), (causal, window)
            if hd > 128:  # both warpgroups take every step
                work = [wgmma_dkdv_work(k0, Sq, hd, window, causal) for k0 in range(0, Sk, 64)]
                assert all(sorted(q0 for wg, q0, *_ in w if wg == 0)
                           == sorted(q0 for wg, q0, *_ in w if wg == 1) for w in work)
