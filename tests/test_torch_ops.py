"""The port's kernels as ``torch.library`` operators, on the CPU.

Each of the five operators (``rmsnorm``, ``rmsnorm_bwd``,
``flash_attention`` with and without the LSE, ``flash_attention_bwd``,
``ssd_scan``) passes ``torch.library.opcheck`` (schema, autograd
registration, fake implementation against the real outputs' shapes,
dtypes and strides, and AOT dispatch with dynamic shapes) at a small shape
and an odd one, and its CPU implementation gives the plain version's bits.
``chip_smoke.py`` phase 3 runs the same ``opcheck`` on CUDA tensors.
"""

import numpy as np
import pytest
import torch
from torch.library import opcheck

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_bwd_plain, flash_attention_plain
from repro_torch.kernels.rmsnorm import rmsnorm_bwd_plain, rmsnorm_plain
from repro_torch.kernels.ssd_scan import ssd_scan_plain

O = torch.ops.repro_torch


def _t(rng, *shape, dtype=torch.float32, grad=False, positive=False):
    a = rng.standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(np.abs(a) + 0.1 if positive else a).to(dtype)
    return t.requires_grad_(grad)


def _rmsnorm(rng, shape, dtype, grad=False):
    return (_t(rng, *shape, dtype=dtype, grad=grad), _t(rng, shape[-1], grad=grad), 1e-6)


def _flash(rng, B, Sq, Sk, H, KV, hd, dtype, grad=False, causal=True, window=None,
           softcap=None, scale=None):
    return (_t(rng, B, Sq, H, hd, dtype=dtype, grad=grad),
            _t(rng, B, Sk, KV, hd, dtype=dtype, grad=grad),
            _t(rng, B, Sk, KV, hd, dtype=dtype, grad=grad), causal, window, softcap, scale)


def _flash_bwd(rng, B, S, H, KV, hd, dtype, window=None, scale=None, causal=True, Sk=None):
    q, k, v = (a.detach() for a in _flash(rng, B, S, Sk or S, H, KV, hd, dtype)[:3])
    o, lse = O.flash_attention_lse(q, k, v, causal, window, None, scale)
    return q, k, v, o, _t(rng, B, S, H, hd, dtype=dtype), lse, causal, window, None, scale


def _ssd(rng, b, s, h, p, g, n, dtype):
    return (_t(rng, b, s, h, p, dtype=dtype), _t(rng, b, s, h, dtype=dtype, positive=True) * 0.1,
            -_t(rng, h, dtype=dtype, positive=True), _t(rng, b, s, g, n, dtype=dtype),
            _t(rng, b, s, g, n, dtype=dtype))


# (operator, inputs from a numpy generator); the second case of each is odd:
# ragged lengths, widths that take no 16-byte vector, window and softcap.
CASES = {
    "rmsnorm": (O.rmsnorm, lambda rng: _rmsnorm(rng, (4, 64), torch.float32, grad=True)),
    "rmsnorm-odd": (O.rmsnorm, lambda rng: _rmsnorm(rng, (3, 5, 37), torch.bfloat16, grad=True)),
    "rmsnorm_bwd": (O.rmsnorm_bwd,
                    lambda rng: _rmsnorm(rng, (4, 64), torch.float32)[:2]
                    + (_t(rng, 4, 64), 1e-6)),
    "rmsnorm_bwd-odd": (O.rmsnorm_bwd,
                        lambda rng: _rmsnorm(rng, (7, 37), torch.bfloat16)[:2]
                        + (_t(rng, 7, 37, dtype=torch.bfloat16), 1e-5)),
    "flash_attention": (O.flash_attention,
                        lambda rng: _flash(rng, 1, 64, 64, 4, 2, 16, torch.float32)),
    "flash_attention-odd": (O.flash_attention,
                            lambda rng: _flash(rng, 2, 33, 70, 2, 1, 32, torch.bfloat16,
                                               causal=False, window=7, softcap=30.0,
                                               scale=0.2)),
    "flash_attention_lse": (O.flash_attention_lse,
                            lambda rng: _flash(rng, 1, 64, 64, 4, 2, 16, torch.float32,
                                               grad=True)),
    "flash_attention_lse-odd": (O.flash_attention_lse,
                                lambda rng: _flash(rng, 1, 37, 37, 3, 1, 16, torch.bfloat16,
                                                   grad=True)),
    "flash_attention_lse-unmasked": (O.flash_attention_lse,
                                     lambda rng: _flash(rng, 1, 70, 37, 4, 2, 16, torch.float32,
                                                        grad=True, causal=False)),
    "flash_attention_bwd": (O.flash_attention_bwd,
                            lambda rng: _flash_bwd(rng, 1, 64, 4, 2, 16, torch.float32)),
    "flash_attention_bwd-odd": (O.flash_attention_bwd,
                                lambda rng: _flash_bwd(rng, 2, 37, 3, 1, 32, torch.bfloat16)),
    "flash_attention_bwd-window": (O.flash_attention_bwd,
                                   lambda rng: _flash_bwd(rng, 2, 70, 5, 1, 16, torch.float32,
                                                          window=9, scale=0.3)),
    "flash_attention_bwd-unmasked": (O.flash_attention_bwd,
                                     lambda rng: _flash_bwd(rng, 2, 37, 4, 2, 16, torch.float32,
                                                            causal=False, Sk=70)),
    "ssd_scan": (O.ssd_scan, lambda rng: _ssd(rng, 1, 64, 2, 8, 1, 4, torch.float32)),
    "ssd_scan-odd": (O.ssd_scan, lambda rng: _ssd(rng, 2, 70, 4, 12, 2, 5, torch.bfloat16)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_opcheck_on_cpu_tensors(case):
    op, make = CASES[case]
    result = opcheck(op, make(np.random.default_rng(0)))
    assert set(result.values()) == {"SUCCESS"}, result


# Each operator's CPU implementation against its plain version, bit for bit.
PLAIN = {
    "rmsnorm": lambda x, s, eps: rmsnorm_plain(x, s, eps),
    "rmsnorm_bwd": lambda x, s, dy, eps: rmsnorm_bwd_plain(x, s, dy, eps),
    "flash_attention": lambda q, k, v, c, w, sc, s: flash_attention_plain(
        q, k, v, causal=c, window=w, softcap=sc, scale=s),
    "flash_attention_lse": lambda q, k, v, c, w, sc, s: flash_attention_plain(
        q, k, v, causal=c, window=w, softcap=sc, scale=s, return_lse=True),
    "flash_attention_bwd": lambda q, k, v, o, do, lse, c, w, sc, s: flash_attention_bwd_plain(
        q, k, v, o, do, lse, causal=c, window=w, softcap=sc, scale=s),
    "ssd_scan": ssd_scan_plain,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_implementation_is_the_plain_version(case):
    op, make = CASES[case]
    args = [a.detach() if isinstance(a, torch.Tensor) else a
            for a in make(np.random.default_rng(1))]
    got, want = op(*args), PLAIN[case.split("-")[0]](*args)
    got, want = ((got,), (want,)) if isinstance(got, torch.Tensor) else (got, want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.is_contiguous()
        assert torch.equal(g, w)


def test_gradients_reach_the_backward_operators():
    """Autograd of ``fused_rmsnorm`` and ``flash_mha`` runs the backward
    operators, whose CPU implementations are the plain backwards."""
    rng = np.random.default_rng(2)
    x, scale, _ = _rmsnorm(rng, (6, 32), torch.float32, grad=True)
    dy = _t(rng, 6, 32)
    dx, dscale = torch.autograd.grad(ops.fused_rmsnorm(x, scale), (x, scale), dy)
    want = rmsnorm_bwd_plain(x.detach(), scale.detach(), dy, 1e-6)
    assert torch.equal(dx, want[0]) and torch.equal(dscale, want[1])
    q, k, v = _flash(rng, 1, 40, 40, 4, 2, 16, torch.float32, grad=True)[:3]
    do = _t(rng, 1, 40, 4, 16)
    got = torch.autograd.grad(ops.flash_mha(q, k, v), (q, k, v), do)
    o, lse = flash_attention_plain(q.detach(), k.detach(), v.detach(), return_lse=True)
    want = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o.contiguous(), do, lse)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_label_is_free_on_real_tensors():
    """On a real tensor the label is the tensor itself: no copy, no op."""
    x = torch.randn(3, 4)
    assert ops.label(x, "block_in") is x
    assert ops.label(x, "block_in").untyped_storage().data_ptr() == \
        x.untyped_storage().data_ptr()
    y = torch.ops.repro_torch.label(x, "attn_out")  # the operator: a view
    assert y.untyped_storage().data_ptr() == x.untyped_storage().data_ptr() and y._base is x
