"""The port's backward kernels' plain versions against JAX autodiff on the CPU.

The JAX kernels have no backward: the reference trains through jnp code
that XLA differentiates.  So ``rmsnorm_bwd_plain`` and
``flash_attention_bwd_plain`` are held to ``jax.grad`` of the JAX package's
oracles (``repro.kernels.ref``), and to ``torch.autograd`` of the port's own
plain forwards, on inputs drawn with numpy.  Also: the plain forward's
log-sum-exp, and the routing of ``ops.fused_rmsnorm`` and ``ops.flash_mha``
through their autograd Functions (plain on the CPU, launching nothing).
The CUDA kernels are held to these plain versions on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (bwd_variant, check_bwd_supported,
                                                 flash_attention_bwd_plain, flash_attention_plain)
from repro_torch.kernels.rmsnorm import rmsnorm_bwd_plain, rmsnorm_plain

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


# ------------------------------------------------------------------ rmsnorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(37, 64), (2, 5, 128), (4, 1020),
                                   (64, 2560), (2, 16, 8, 128)])  # qwen3-4b's train widths
def test_rmsnorm_bwd_plain_matches_jax_grad(shape, dtype):
    rng = np.random.default_rng(0)
    x, dy = _draw(rng, shape, dtype), _draw(rng, shape, dtype)
    scale = (rng.random(shape[-1], dtype=np.float32) + 0.5)

    def f(x, s):
        return jax_ref.rmsnorm_reference(x, s)

    _, vjp = jax.vjp(f, jnp.asarray(x, dtype), jnp.asarray(scale))
    jdx, jds = vjp(jnp.asarray(dy, dtype))
    dx, ds = rmsnorm_bwd_plain(_torch(x, dtype), torch.from_numpy(scale), _torch(dy, dtype))
    assert dx.dtype == getattr(torch, dtype) and ds.dtype == torch.float32
    _close(dx, jdx, TOL[dtype])
    # dscale sums over rows: held relative to its largest entry
    np.testing.assert_allclose(ds.numpy() / np.abs(jds).max(),
                               np.asarray(jds) / np.abs(jds).max(), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_plain_matches_autograd_of_plain(dtype):
    rng = np.random.default_rng(1)
    x = _torch(_draw(rng, (6, 7, 64), dtype), dtype).requires_grad_()
    s = torch.from_numpy(rng.random(64, dtype=np.float32) + 0.5).requires_grad_()
    dy = _torch(_draw(rng, (6, 7, 64), dtype), dtype)
    want = torch.autograd.grad(rmsnorm_plain(x, s), (x, s), dy)
    got = rmsnorm_bwd_plain(x.detach(), s.detach(), dy)
    _close(got[0], want[0].float(), TOL[dtype])
    _close(got[1] / want[1].abs().max(), (want[1] / want[1].abs().max()).numpy(), TOL[dtype])


# -------------------------------------------------------------------- flash
FLASH_SHAPES = [  # (B, S, H, KV, hd): S ragged to the 64- and 128-row tiles
    (2, 70, 4, 2, 16),
    (1, 130, 4, 1, 32),
    (1, 37, 2, 2, 128),
]


def _qkv(rng, B, S, H, KV, hd, dtype):
    return (_draw(rng, (B, S, H, hd), dtype), _draw(rng, (B, S, KV, hd), dtype),
            _draw(rng, (B, S, KV, hd), dtype), _draw(rng, (B, S, H, hd), dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_bwd_plain_matches_jax_grad(shape, dtype):
    """Causal GQA attention: dq, dk, dv against jax.vjp of ``mha_reference``."""
    q, k, v, do = _qkv(np.random.default_rng(2), *shape, dtype)
    _, vjp = jax.vjp(lambda q, k, v: jax_ref.mha_reference(q, k, v, causal=True),
                     *(jnp.asarray(a, dtype) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, dtype))
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    o, lse = flash_attention_plain(tq, tk, tv, return_lse=True)
    got = flash_attention_bwd_plain(tq, tk, tv, o, _torch(do, dtype), lse)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        _close(g, w, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_plain_matches_autograd_of_plain(dtype):
    q, k, v, do = (_torch(a, dtype) for a in _qkv(np.random.default_rng(3), 2, 70, 4, 2, 32,
                                                   dtype))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*leaves), leaves, do)
    o, lse = flash_attention_plain(q, k, v, return_lse=True)
    for g, w in zip(flash_attention_bwd_plain(q, k, v, o, do, lse), want):
        _close(g, w.float(), TOL[dtype])


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_plain_lse_matches_reference_logsumexp(shape):
    B, S, H, KV, hd = shape
    q, k, v, _ = _qkv(np.random.default_rng(4), *shape, "float32")
    kh = np.repeat(k, H // KV, axis=2)
    s = jnp.einsum("bqhd,bshd->bhqs", q, kh) * hd**-0.5
    s = jnp.where(jnp.tril(jnp.ones((S, S), bool))[None, None], s, -1e30)
    want = jax.nn.logsumexp(s, axis=-1)
    out, lse = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    _close(lse, want, TOL["float32"])
    _close(out, jax_ref.mha_reference(q, k, v), TOL["float32"])


def test_flash_bwd_raises_outside_causal():
    """Unmasked attention with a window and a window with Sq > Sk are
    refused, naming B2d; a window with Sq <= Sk, unmasked attention without
    one, a softcap and head dim 256 are taken."""
    for hd, sk, kw in ((16, 8, dict(causal=False, window=4)), (16, 4, dict(window=4))):
        q = torch.zeros(1, 8, 2, hd)
        k = torch.zeros(1, sk, 2, hd)
        lse = torch.zeros(1, 2, 8)
        with pytest.raises(NotImplementedError, match="B2d"):
            flash_attention_bwd_plain(q, k, k, q, q, lse, **kw)
        with pytest.raises(NotImplementedError, match="B2d"):
            ops.flash_mha(q.clone().requires_grad_(), k, k, **kw)
    for causal, window, softcap, hd, sq, sk in ((True, 4, None, 128, 8, 8),
                                                (False, None, None, 128, 8, 3),
                                                (False, None, None, 128, 3, 8),
                                                (True, None, 30.0, 16, 8, 8),
                                                (True, None, None, 256, 8, 8),
                                                (True, 4, 50.0, 256, 8, 8)):
        check_bwd_supported(causal, window, softcap, hd, sq, sk)


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("dtype,hd,offset,want", [
    (torch.bfloat16, 128, 0, "wgmma"),
    (torch.bfloat16, 64, 0, "wgmma"),
    (torch.bfloat16, 256, 0, "wgmma"),    # the gemmas' head dim
    (torch.bfloat16, 256, 1, "simt"),
    (torch.bfloat16, 32, 0, "simt"),      # head dims the tensor-core tiles do not take
    (torch.float32, 128, 0, "simt"),      # fp32 keeps IEEE products
    (torch.bfloat16, 128, 1, "simt"),     # dO a view one element in: not 16-byte aligned
])
def test_bwd_variant_routing(dtype, hd, offset, want):
    o = torch.zeros(1, 4, 2, hd, dtype=dtype)
    do = torch.zeros(o.numel() + offset, dtype=dtype)[offset:].view(o.shape)
    assert bwd_variant(o, do) == want


def test_autograd_functions_route_to_plain_on_cpu():
    """On CPU tensors the Functions run the plain forward and backward and
    launch no kernel; without a gradient to take, the forward runs alone."""
    ops.reset_launch_counts()
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(rng, 1, 70, 4, 2, 16, "float32"))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_mha(*leaves)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    o, lse = flash_attention_plain(q, k, v, return_lse=True)
    for g, w in zip(got, flash_attention_bwd_plain(q, k, v, o, do, lse)):
        assert torch.equal(g, w)
    assert torch.equal(out.detach(), o)
    assert ops.flash_mha(q, k, v).grad_fn is None

    x = torch.from_numpy(_draw(rng, (3, 5, 32), "float32")).requires_grad_()
    s = torch.from_numpy(rng.random(32, dtype=np.float32) + 0.5).requires_grad_()
    dy = torch.from_numpy(_draw(rng, (3, 5, 32), "float32"))
    y = ops.fused_rmsnorm(x, s)
    got = torch.autograd.grad(y, (x, s), dy)
    want = rmsnorm_bwd_plain(x.detach(), s.detach(), dy)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(y.detach(), rmsnorm_plain(x.detach(), s.detach()))
    with torch.no_grad():
        assert ops.fused_rmsnorm(x, s).grad_fn is None
    assert all(n == 0 for n in ops.launch_counts().values())
    assert {"rmsnorm_bwd", "rmsnorm_bwd/vector", "rmsnorm_bwd/scalar", "flash_attention_bwd",
            "flash_attention_bwd/wgmma", "flash_attention_bwd/mma",
            "flash_attention_bwd/simt"} <= set(ops.launch_counts())
