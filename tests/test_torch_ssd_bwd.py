"""The SSD scan's tc backward (csrc/ssd_scan_bwd_tc.cu) on the CPU.

The card's kernel cannot run here, so its routing is pinned
(``bwd_variant``), and its design is emulated in PyTorch: the state passes
(the entry states and the state gradients of every chunk, carried in fp32),
then the chunk-parallel pass (every gradient of a chunk from its own inputs
and those two states), taking every operand as the source note says the
kernel takes it: rounded to bf16 once, or split into a bf16 hi and lo part.
Without the roundings, in fp32, the emulation is held to
``ssd_scan_bwd_plain``, which checks the decomposition; with them, on bf16
inputs, to ``jax.vjp`` of the reference's ``ssd_chunked`` on the same
values, which checks that the rounding points keep the gradient near the
exact one.  Inputs are made from seeds with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked
from repro_torch.kernels.ssd_scan import (CHUNK, bwd_slices, bwd_variant, check_bwd_args,
                                          ssd_scan_bwd, ssd_scan_bwd_plain)

PLAIN_TOL = 1e-4  # fp32 against fp32: the same terms summed in other orders
# bf16 roundings against the exact gradient: half of the 2e-2 of each
# output's max that chip_smoke.py holds the kernel to on the card.
ROUNDED_TOL = 1e-2


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _operands(dtype, p, n, layout):
    """x [2, 8, 4, p] and B, C [2, 8, 2, n] of ``dtype``: ``"dense"`` tensors,
    ``"views"`` into one [2, 8, 4 p + 4 n] conv output as apply_mamba hands
    them over, or ``"offset"`` views that start one element into a conv
    output one element wider (not 16-byte aligned, odd sequence stride)."""
    if layout == "dense":
        return torch.zeros(2, 8, 4, p, dtype=dtype), *torch.zeros(2, 2, 8, 2, n, dtype=dtype)
    offset = int(layout == "offset")
    xbc = torch.zeros(2, 8, offset + 4 * p + 4 * n, dtype=dtype)[..., offset:]
    return [t.unflatten(-1, shape) for t, shape in
            zip(xbc.split([4 * p, 2 * n, 2 * n], dim=-1), ((4, p), (2, n), (2, n)))]


@pytest.mark.parametrize("dtype,p,n,layout,want", [
    (torch.bfloat16, 64, 128, "views", "tc"),    # mamba2-370m's training layout
    (torch.bfloat16, 64, 128, "dense", "tc"),
    (torch.bfloat16, 128, 128, "dense", "tc"),   # the largest P and N
    (torch.bfloat16, 16, 8, "dense", "tc"),
    (torch.bfloat16, 8, 8, "views", "tc"),
    (torch.bfloat16, 12, 128, "dense", "simt"),  # P not a multiple of 8
    (torch.bfloat16, 64, 100, "dense", "simt"),  # N not a multiple of 8
    (torch.bfloat16, 64, 128, "offset", "simt"),  # not 16-byte aligned, odd stride
    (torch.bfloat16, 16, 8, "offset", "simt"),
    (torch.float32, 64, 128, "views", "simt"),   # fp32 keeps IEEE products
    (torch.float32, 128, 128, "dense", "simt"),
    (torch.float32, 16, 8, "dense", "simt"),
])
def test_bwd_variant_routing_table(dtype, p, n, layout, want):
    """``bwd_variant`` routes by type, P, N and layout alone, as the forward's
    ``variant`` does; the inputs of either variant pass ``check_bwd_args``
    and stop only at the device check, and the wrapper raises on CPU
    tensors whatever the variant."""
    x, Bm, Cm = _operands(dtype, p, n, layout)
    assert bwd_variant(x, Bm, Cm) == want
    dt, A = torch.zeros(2, 8, 4, dtype=dtype), torch.zeros(4, dtype=dtype)
    dy, dstate = torch.zeros(2, 8, 4, p, dtype=dtype), torch.zeros(2, 4, p, n)
    for fn in (check_bwd_args, ssd_scan_bwd):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(x, dt, A, Bm, Cm, dy, dstate)


@pytest.mark.parametrize("b,s,g,rep,sms,want", [
    (4, 2048, 1, 32, 132, 2),   # mamba2-370m's training shape on an H100: 256 blocks
    (4, 2048, 1, 32, 100, 1),   # 128 blocks already give 100 SMs one each
    (1, 200, 1, 2, 132, 2),     # never more slices than heads
    (2, 256, 2, 4, 132, 4),
    (1, 1000, 1, 6, 40, 3),     # the fewest that reach the SMs, a divisor of rep
])
def test_bwd_slices(b, s, g, rep, sms, want):
    assert bwd_slices(b, s, g, rep, sms) == want


def _split(t):
    """t as the kernel carries it into a product in two bf16 parts: hi, the
    value rounded to bf16, and lo, the rest rounded to bf16 (about 16 of
    fp32's 24 mantissa bits)."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def _tc_bwd_emulation(x, dt, A, Bm, Cm, dy, dstate, rounded=True):
    """The tc backward's decomposition (csrc/ssd_scan_bwd_tc.cu) in PyTorch.
    ``rounded``: take the operands as the source note says the kernel takes
    them.  Lm and W, the second operands of the chunk pass's products with
    them, are rounded to bf16 once each.  B o dt exp(cum_last - cum) and
    C o exp(cum) in the state passes' products, and the entry states and
    state gradients as the state passes store them, are split into a bf16
    hi and lo part each.  Everything else (cum, every exp, the dt factors,
    the carried states, M = Lm o Pd and the sums of d(dt A)) is fp32, and
    x, B, C and dy enter the products as given."""
    r = (lambda t: t.to(torch.bfloat16).float()) if rounded else (lambda t: t)
    sp = _split if rounded else (lambda t: t)
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    xf, dyf = x.float().transpose(1, 2), dy.float().transpose(1, 2)    # [b,h,s,p]
    dtf = dt.float().transpose(1, 2)                                   # [b,h,s]
    a = dtf * A.float()[:, None]
    Bh = Bm.float().repeat_interleave(rep, dim=2).transpose(1, 2)      # [b,h,s,n]
    Ch = Cm.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    bounds = [(c0, min(c0 + CHUNK, s)) for c0 in range(0, s, CHUNK)]
    cums = [a[:, :, c0:c1].cumsum(-1) for c0, c1 in bounds]

    # The state passes: S_in[c + 1] = exp(cum_last) S_in[c] + x^T (B o dt
    # exp(cum_last - cum)) forward, dS[c - 1] = exp(cum_last) dS[c] + dy^T
    # (C o exp(cum)) backward, carried in fp32 and stored as hi and lo.
    state = torch.zeros((b, h, p, n))
    s_in = []
    for (c0, c1), cum in zip(bounds, cums):
        s_in.append(sp(state))
        w = dtf[:, :, c0:c1] * torch.exp(cum[..., -1:] - cum)
        state = (state * torch.exp(cum[..., -1])[..., None, None]
                 + xf[:, :, c0:c1].transpose(-1, -2) @ sp(Bh[:, :, c0:c1] * w[..., None]))
    dS = dstate.float()
    d_out = [None] * len(bounds)
    for i in reversed(range(len(bounds))):
        (c0, c1), cum = bounds[i], cums[i]
        d_out[i] = sp(dS)
        dS = (dS * torch.exp(cum[..., -1])[..., None, None] + dyf[:, :, c0:c1].transpose(-1, -2)
              @ sp(Ch[:, :, c0:c1] * torch.exp(cum)[..., None]))

    # The chunk pass: each chunk from its own inputs, S_in and dS alone.
    dxdt, dB, dC, da = (torch.empty_like(t) for t in (xf, Bh, Ch, a))
    for i, ((c0, c1), cum) in enumerate(zip(bounds, cums)):
        xc, bc, cc, dyc = xf[:, :, c0:c1], Bh[:, :, c0:c1], Ch[:, :, c0:c1], dyf[:, :, c0:c1]
        dtc, sin, ds = dtf[:, :, c0:c1], s_in[i], d_out[i]
        lower = torch.ones((c1 - c0, c1 - c0), dtype=torch.bool).tril()
        decay = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(~lower, -torch.inf))
        Lm = (cc @ bc.transpose(-1, -2)) * decay
        Pd = (dyc @ xc.transpose(-1, -2)) * dtc[..., None, :]   # dt folded in after the product
        W = Pd * decay
        M = Lm * Pd
        e = torch.exp(cum)
        dec = torch.exp(cum[..., -1:] - cum)
        q = dyc @ sin                                            # [b,h,c,n]
        dC[:, :, c0:c1] = r(W) @ bc + e[..., None] * q
        dB[:, :, c0:c1] = (r(W).transpose(-1, -2) @ cc
                           + (dtc * dec)[..., None] * (xc @ ds))
        gS = bc @ ds.transpose(-1, -2)                           # [b,h,c,p]
        dxdt[:, :, c0:c1] = r(Lm).transpose(-1, -2) @ dyc + dec[..., None] * gS
        span = ((M.cumsum(-1) - M) * lower).sum(-2)
        inter = e * (cc * q).sum(-1)
        sdot = dtc * dec * (xc * gS).sum(-1)
        da[:, :, c0:c1] = (span + inter.flip(-1).cumsum(-1).flip(-1) + sdot.cumsum(-1) - sdot
                           + (torch.exp(cum[..., -1]) * (ds * sin).sum((-2, -1)))[..., None])
    dx = (dxdt * dtf[..., None]).transpose(1, 2)
    ddt = ((xf * dxdt).sum(-1) + A.float()[:, None] * da).transpose(1, 2)
    dA = (dtf * da).sum((0, 2))
    dBm = dB.transpose(1, 2).unflatten(2, (g, rep)).sum(3)
    dCm = dC.transpose(1, 2).unflatten(2, (g, rep)).sum(3)
    return dx, ddt, dA, dBm, dCm


# (b, s, h, p, g, n, a nonzero dstate): a ragged length (1000 = 15 x 64 +
# 40), two groups, a nonzero final-state cotangent, the largest P and N.
CASES = {
    "ragged": (1, 1000, 4, 16, 1, 16, False),
    "two-groups": (2, 256, 8, 16, 2, 16, False),
    "dstate": (2, 300, 4, 16, 1, 32, True),
    "p128-n128": (1, 200, 2, 128, 1, 128, True),
}


def _inputs(case, seed):
    """x, dt (about 0.05, so the state carries across chunks), A (-1 to -16
    over the heads), Bm, Cm, dy, dstate as fp32 numpy, rounded to bf16."""
    b, s, h, p, g, n, with_state = CASES[case]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, s, h, p), dtype=np.float32),
              np.log1p(np.exp(rng.standard_normal((b, s, h)) - 3.0)).astype(np.float32),
              -np.linspace(1.0, 16.0, h, dtype=np.float32),
              rng.standard_normal((b, s, g, n), dtype=np.float32),
              rng.standard_normal((b, s, g, n), dtype=np.float32),
              rng.standard_normal((b, s, h, p), dtype=np.float32),
              (rng.standard_normal((b, h, p, n), dtype=np.float32) if with_state
               else np.zeros((b, h, p, n), np.float32))]
    return [np.asarray(torch.from_numpy(a).bfloat16().float()) for a in arrays]


@pytest.mark.parametrize("case", list(CASES))
def test_emulation_without_rounding_is_the_plain_backward(case):
    """The decomposition: state passes, then chunks in parallel, in fp32."""
    T = [torch.from_numpy(a) for a in _inputs(case, 20)]
    got = _tc_bwd_emulation(*T, rounded=False)
    want = ssd_scan_bwd_plain(*T)
    for name, gt, w in zip(("dx", "ddt", "dA", "dBm", "dCm"), got, want):
        assert gt.shape == w.shape
        assert _rel(gt, w) < PLAIN_TOL, (name, _rel(gt, w))


def _chunk_for(s: int) -> int:
    """A chunk of the reference's ``ssd_chunked`` that divides s."""
    return next(c for c in (64, 50, 40, 25, 20) if s % c == 0)


@pytest.mark.parametrize("case", list(CASES))
def test_rounded_emulation_matches_jax_vjp(case):
    """The kernel's operands on bf16 inputs against ``jax.vjp`` of the
    reference's ``ssd_chunked`` on the same values in fp32: each of dx, ddt,
    dA, dBm and dCm within ROUNDED_TOL of its max."""
    arrays = _inputs(case, 30)
    x, dt, A, Bm, Cm, dy, dstate = arrays
    _, vjp = jax.vjp(lambda *a: ssd_chunked(*a, _chunk_for(x.shape[1])),
                     *(jnp.asarray(v) for v in (x, dt, A, Bm, Cm)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dstate)))
    T = [torch.from_numpy(v).bfloat16() for v in arrays[:6]] + [torch.from_numpy(dstate)]
    assert bwd_variant(T[0], T[3], T[4]) == "tc"
    got = _tc_bwd_emulation(*T)
    for name, gt, w in zip(("dx", "ddt", "dA", "dBm", "dCm"), got, want):
        assert tuple(gt.shape) == w.shape
        assert _rel(gt, w) < ROUNDED_TOL, (name, _rel(gt, w))
