"""Mamba-2 SSD chunked scan: two CUDA kernels and their plain version.

Counterpart of ``repro/kernels/ssd_scan.py:65 ssd_scan`` (a Pallas TPU
kernel).  ``ssd_scan`` launches a Hopper kernel on CUDA tensors:
``variant(x, Bm, Cm)`` names which one, by type, shape and layout alone.

- ``"tc"`` (``csrc/ssd_scan_tc.cu``): bf16 with P and N multiples of 8, on
  the tensor cores (mma.sync, fp32 sums), a block for each 32 rows of a
  (batch, head)'s state, 64-step chunks, after a prepass that computes
  C B^T once per (batch, chunk, group) into fp32 scratch this wrapper
  allocates.  It rounds three operands to bf16 (see the source note) and
  copies 16-byte rows, so it takes 16-byte aligned x, B and C whose batch
  and sequence strides are multiples of 8 elements, as every call on the
  served model's path has.
- ``"simt"`` (``csrc/ssd_scan.cu``): fp32, whose 1e-4 parity needs IEEE
  fp32 products (TF32 keeps about three decimal digits), and the bf16
  inputs that the tc kernel does not take; on the CUDA cores, a block for
  each (batch, head), 64-step chunks.

Each launch counts in ``ssd_scan.launches`` and in
``ssd_scan.variant_launches[variant]``.  ``ssd_scan_plain`` repeats the
chunked arithmetic in PyTorch, fp32 throughout (64-step chunks too) and is
what the CPU runs; the kernels are held to it on the card.  All three
return the final state beside y, which the Pallas kernel keeps in scratch
and drops: the decode cache starts from it.  None needs the length to
divide the chunk, and the chunk does not change the function.  The source
notes in the ``.cu`` files give each kernel's bound and design.

The ``torch.library`` operator ``repro_torch.ssd_scan`` carries it: the
dispatcher sends a CUDA tensor to ``ssd_scan`` (the kernel, or a raise), a
CPU tensor to the plain version, and a fake or meta tensor to a fake
implementation that returns the real outputs' shapes, dtypes and strides
(``variant`` reads addresses, so it runs only in the wrapper).

Its gradient is ``repro_torch.ssd_scan_bwd`` (``kernels/ops.py`` registers
it on the forward operator): ``ssd_scan_bwd`` launches the backward kernel
that ``bwd_variant(x, Bm, Cm)`` names, by the forward's rule:

- ``"tc"`` (``csrc/ssd_scan_bwd_tc.cu``): bf16 with P and N multiples of 8
  and the forward tc kernel's layout, on the tensor cores (mma.sync, fp32
  sums), in two kernels: the state passes carry the entry states and the
  state gradients across the chunks (a block for each 64 rows of a (batch,
  head)'s state and direction) into scratch this wrapper allocates, as bf16
  hi and lo parts, then a block for each (chunk, batch, group, slice of the
  group's heads) computes every gradient of its chunk from them, summing dB
  and dC over its heads.  It rounds three operands to bf16 (see the source
  note).
- ``"simt"`` (``csrc/ssd_scan_bwd.cu``): fp32, whose 1e-4 parity needs IEEE
  fp32 products, and the bf16 inputs the tc kernel does not take: fp32
  sums on the CUDA cores, a block for each (batch, head), which recomputes
  the chunks' entry states from the five inputs.

``ssd_scan_bwd_plain`` is the same function in PyTorch, what the CPU runs.
``flops`` and ``bwd_flops`` count the work of the forward's and the
backward's chunking on given shapes: the tracer prices both operators by
them.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

CHUNK = 64     # both kernels' own chunk (L in csrc/ssd_scan.cu and ssd_scan_tc.cu)
MAX_DIM = 128  # largest head dim P and state N the kernels take
_LIBS = {"tc": "ssd_scan_tc", "simt": "ssd_scan"}


def variant(x, Bm, Cm) -> str:
    """The kernel ``ssd_scan`` launches for x [b,s,h,p] and Bm, Cm [b,s,g,n]:
    ``"tc"`` for bf16 with p and n multiples of 8 whose x, Bm and Cm start at
    16-byte aligned addresses with batch and sequence strides that are
    multiples of 8 elements, ``"simt"`` otherwise."""
    rows = all(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0
               for t in (x, Bm, Cm))
    return ("tc" if x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0
            and Bm.shape[-1] % 8 == 0 and rows else "simt")

_I, _P, _L = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
_ARGTYPES = [_I] + [_P] * 7 + [_I] * 6 + [_L] * 8 + [_P]  # simt's ssd_scan_fwd
_TC_ARGTYPES = [_I] + [_P] * 8 + [_I] * 6 + [_L] * 8 + [_P]  # ssd_scan_tc_fwd: + C B^T scratch


def ssd_scan_plain(x, dt, A, Bm, Cm):
    """x [b,s,h,p], dt [b,s,h] (> 0), A [h] (< 0), Bm/Cm [b,s,g,n] ->
    (y [b,s,h,p] in x's dtype, final state [b,h,p,n] fp32)."""
    b, s, h, p = x.shape
    n = Bm.shape[3]
    rep = h // Bm.shape[2]
    dtf = dt.float()
    xdt = (x.float() * dtf[..., None]).transpose(1, 2)           # [b,h,s,p]
    dA = (dtf * A.float()).transpose(1, 2)                       # [b,h,s]
    Bh = Bm.float().repeat_interleave(rep, dim=2).transpose(1, 2)  # [b,h,s,n]
    Ch = Cm.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    y = torch.empty((b, h, s, p), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, CHUNK):
        c1 = min(c0 + CHUNK, s)  # a ragged last chunk equals a zero-padded one
        xc, bc, cc = xdt[:, :, c0:c1], Bh[:, :, c0:c1], Ch[:, :, c0:c1]
        cum = dA[:, :, c0:c1].cumsum(-1)                         # [b,h,c]
        lower = torch.ones((c1 - c0, c1 - c0), dtype=torch.bool, device=x.device).tril()
        # Mask before the exp: above the diagonal the differences are positive.
        diff = (cum[..., :, None] - cum[..., None, :]).masked_fill(~lower, -torch.inf)
        decay_in = torch.exp(diff)                                # [b,h,c,c]
        yc = ((cc @ bc.transpose(-1, -2)) * decay_in) @ xc
        yc = yc + torch.exp(cum)[..., None] * (cc @ state.transpose(-1, -2))
        decay_out = torch.exp(cum[..., -1:] - cum)                # [b,h,c]
        state = (state * torch.exp(cum[..., -1])[..., None, None]
                 + (xc * decay_out[..., None]).transpose(-1, -2) @ bc)
        y[:, :, c0:c1] = yc
    return y.transpose(1, 2).to(x.dtype), state


def _chunks(s: int):
    """The lengths of the 64-step chunks of s steps, the last one ragged."""
    return [min(CHUNK, s - c0) for c0 in range(0, s, CHUNK)]


def flops(b: int, s: int, h: int, p: int, n: int) -> int:
    """FLOPs of the forward's chunking on these shapes (a multiply-add is
    two): for a chunk of c steps, the lower triangle of C B^T and of its
    product with x dt, c (c + 1) / 2 (N + P) multiply-adds, and the
    inter-chunk term and the state update, 2 c P N."""
    return 2 * b * h * sum(c * (c + 1) // 2 * (n + p) + 2 * c * p * n for c in _chunks(s))


def bwd_flops(b: int, s: int, h: int, p: int, n: int) -> int:
    """FLOPs of the backward's chunking on these shapes: for a chunk of c
    steps, the lower triangles of C B^T and dy (x dt)^T and of the three
    products with them (dC, dB, d(x dt)), c (c + 1) / 2 (3 N + 2 P)
    multiply-adds, and five c x P x N products: the state recomputed, dy
    against the entry state (dC's inter-chunk term), the carried state
    gradient against x dt (dB) and against B (d(x dt)), and its update."""
    return 2 * b * h * sum(c * (c + 1) // 2 * (3 * n + 2 * p) + 5 * c * p * n
                           for c in _chunks(s))


def check_args(x, dt, A, Bm, Cm) -> None:
    """Raise ValueError on what the kernel does not take."""
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or Bm.ndim != 4 or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: want x [b,s,h,p], dt [b,s,h], A [h], Bm = Cm [b,s,g,n], got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) or tuple(Bm.shape[:2]) != (b, s)
            or min(b, s, h, p, g, n) < 1 or h % g):
        raise ValueError(f"ssd_scan: mismatched shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, Bm {tuple(Bm.shape)}")
    if p > MAX_DIM or n > MAX_DIM:
        raise ValueError(f"ssd_scan: head dim and state must be at most {MAX_DIM}, got {p}, {n}")
    if x.dtype not in _build.DTYPE_CODES or any(t.dtype != x.dtype for t in (dt, A, Bm, Cm)):
        raise ValueError(f"ssd_scan: x, dt, A, Bm, Cm must share float32 or bfloat16, got "
                         f"{[str(t.dtype) for t in (x, dt, A, Bm, Cm)]}")
    # Batch and sequence may be strided (views into the conv output); the rest is dense.
    if not (x[0, 0].is_contiguous() and dt[0, 0].is_contiguous() and A.is_contiguous()
            and Bm[0, 0].is_contiguous() and Cm[0, 0].is_contiguous()):
        raise ValueError("ssd_scan: the axes after batch and sequence must be contiguous")
    if x.device.type != "cuda" or any(t.device != x.device for t in (dt, A, Bm, Cm)):
        raise ValueError(f"ssd_scan: the kernel takes CUDA tensors on one device, got "
                         f"{[str(t.device) for t in (x, dt, A, Bm, Cm)]}")


def _launch(var: str, x, dt, A, Bm, Cm):
    """Run kernel ``var`` on arguments that ``check_args`` passed; count nothing."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lib = _LIBS[var]
    ptrs = [x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr()]
    if var == "tc":  # the prepass's C B^T, one fp32 chunk-square per (batch, group, chunk)
        cb = torch.empty((b, g, -(-s // CHUNK), CHUNK, CHUNK), dtype=torch.float32,
                         device=x.device)
        ptrs.append(cb.data_ptr())
    fn = _build.function(lib, f"{lib}_fwd", _TC_ARGTYPES if var == "tc" else _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(_build.DTYPE_CODES[x.dtype], *ptrs, y.data_ptr(), state.data_ptr(), b, s, h, g,
                 p, n, x.stride(0), x.stride(1), dt.stride(0), dt.stride(1), Bm.stride(0),
                 Bm.stride(1), Cm.stride(0), Cm.stride(1),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err)
    return y, state


def ssd_scan(x, dt, A, Bm, Cm):
    """x [b,s,h,p], dt [b,s,h], A [h], Bm/Cm [b,s,g,n] -> (y [b,s,h,p] in x's
    dtype, final state [b,h,p,n] fp32), through the CUDA kernel that
    ``variant(x, Bm, Cm)`` names."""
    check_args(x, dt, A, Bm, Cm)
    var = variant(x, Bm, Cm)
    y, state = _launch(var, x, dt, A, Bm, Cm)
    ssd_scan.launches += 1
    ssd_scan.variant_launches[var] += 1
    return y, state


ssd_scan.launches = 0
ssd_scan.variant_launches = {"tc": 0, "simt": 0}


# ---------------------------------------------------------------- backward
def ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, dstate):
    """The gradient of ``ssd_scan_plain``: the five inputs, dy [b,s,h,p] (y's
    cotangent) and dstate [b,h,p,n] fp32 (the final state's) -> (dx, ddt,
    dA, dBm, dCm), each in its input's dtype and shape, computed in fp32
    over the same 64-step chunks, in closed form (an operator's CPU kernel
    cannot record autograd under a dispatch mode, as ``opcheck`` runs it).
    Per chunk, with cum the cumulative sum of dt A, decay the masked
    exp(cum_t - cum_s), Lm = C B^T o decay, Pd = dy (x dt)^T, W = Pd o decay,
    S_in the entering state and dS the gradient of the state that leaves the
    chunk (dstate for the last), walked from the last chunk to the first:

      d(x dt) = Lm^T dy + exp(cum_last - cum) o (B dS^T)
      dC      = W B + exp(cum) o (dy S_in)
      dB      = W^T C + exp(cum_last - cum) o ((x dt) dS)
      d(dt A)_s = sum_{t >= s > u} (Lm o Pd)_tu + sum_{t >= s} exp(cum_t) C_t . (S_in^T dy_t)
                  + exp(cum_last) <dS, S_in> + sum_{t < s} (x dt)_t . (d(x dt)_t's dS term)
      dS_in   = exp(cum_last) dS + (exp(cum) o dy)^T C

    then dx = dt d(x dt), ddt = x . d(x dt) + A d(dt A), dA = sum dt
    d(dt A), and dB, dC summed over the heads of a group.  d(dt A) is the
    reverse cumulative sum of cum's gradient, written so that nothing
    cancels: the intra-chunk pairs whose decay spans step s, the inter-chunk
    terms after it, and the state's terms before it (the form dy . y -
    (x dt) . d(x dt) summed from the end cancels its diagonal and the
    state's total, and in fp32 its dA missed the reference's by more than
    the 1e-4 the tests hold it to)."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    dtf = dt.float().transpose(1, 2)                              # [b,h,s]
    xf = x.float().transpose(1, 2)                                # [b,h,s,p]
    xdt = xf * dtf[..., None]
    a = dtf * A.float()[:, None]
    Bh = Bm.float().repeat_interleave(rep, dim=2).transpose(1, 2)  # [b,h,s,n]
    Ch = Cm.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    dyf = dy.float().transpose(1, 2)
    bounds = [(c0, min(c0 + CHUNK, s)) for c0 in range(0, s, CHUNK)]
    states = [torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)]
    for c0, c1 in bounds[:-1]:  # each chunk's entry state
        cum = a[:, :, c0:c1].cumsum(-1)
        decay_out = torch.exp(cum[..., -1:] - cum)
        states.append(states[-1] * torch.exp(cum[..., -1])[..., None, None]
                      + (xdt[:, :, c0:c1] * decay_out[..., None]).transpose(-1, -2)
                      @ Bh[:, :, c0:c1])
    dxdt, dB, dC, da = (torch.empty_like(t) for t in (xdt, Bh, Ch, a))
    dS = dstate.float()
    for i in reversed(range(len(bounds))):
        c0, c1 = bounds[i]
        xc, bc, cc, dyc = xdt[:, :, c0:c1], Bh[:, :, c0:c1], Ch[:, :, c0:c1], dyf[:, :, c0:c1]
        s_in = states[i]
        cum = a[:, :, c0:c1].cumsum(-1)
        lower = torch.ones((c1 - c0, c1 - c0), dtype=torch.bool, device=x.device).tril()
        # Mask before the exp: above the diagonal the differences are positive.
        decay = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(~lower, -torch.inf))
        Lm = (cc @ bc.transpose(-1, -2)) * decay
        Pd = dyc @ xc.transpose(-1, -2)
        W = Pd * decay
        e_in = torch.exp(cum)[..., None]
        decay_out = torch.exp(cum[..., -1:] - cum)[..., None]
        dx_state = decay_out * (bc @ dS.transpose(-1, -2))
        dxdt[:, :, c0:c1] = Lm.transpose(-1, -2) @ dyc + dx_state
        q = dyc @ s_in                                             # [b,h,c,n]
        dC[:, :, c0:c1] = W @ bc + e_in * q
        dB[:, :, c0:c1] = W.transpose(-1, -2) @ cc + decay_out * (xc @ dS)
        M = Lm * Pd
        span = ((M.cumsum(-1) - M) * lower).sum(-2)          # sum over t >= s > u of M_tu
        inter = e_in[..., 0] * (cc * q).sum(-1)
        state = (xc * dx_state).sum(-1)
        da[:, :, c0:c1] = (span + inter.flip(-1).cumsum(-1).flip(-1) + state.cumsum(-1) - state
                           + (torch.exp(cum[..., -1]) * (dS * s_in).sum((-2, -1)))[..., None])
        dS = dS * torch.exp(cum[..., -1])[..., None, None] + (e_in * dyc).transpose(-1, -2) @ cc
    dx = (dxdt * dtf[..., None]).transpose(1, 2)
    ddt = ((xf * dxdt).sum(-1) + A.float()[:, None] * da).transpose(1, 2)
    dA = (dtf * da).sum((0, 2))
    dBm = dB.transpose(1, 2).unflatten(2, (g, rep)).sum(3)
    dCm = dC.transpose(1, 2).unflatten(2, (g, rep)).sum(3)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype), dBm.to(Bm.dtype),
            dCm.to(Cm.dtype))


_BWD_ARGTYPES = [_I] + [_P] * 13 + [_I] * 6 + [_L] * 8 + [_P]


def check_bwd_args(x, dt, A, Bm, Cm, dy, dstate) -> None:
    """Raise ValueError on what the backward kernel does not take: the
    forward's inputs as ``check_args`` takes them, dy contiguous like y and
    dstate contiguous fp32 [b,h,p,n], on x's device."""
    check_args(x, dt, A, Bm, Cm)
    b, s, h, p = x.shape
    n = Bm.shape[3]
    if (dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous()
            or dy.device != x.device):
        raise ValueError(f"ssd_scan_bwd: dy must be contiguous {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}, got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if (tuple(dstate.shape) != (b, h, p, n) or dstate.dtype != torch.float32
            or not dstate.is_contiguous() or dstate.device != x.device):
        raise ValueError(f"ssd_scan_bwd: dstate must be contiguous float32 {(b, h, p, n)} on "
                         f"{x.device}, got {dstate.dtype} {tuple(dstate.shape)} on "
                         f"{dstate.device}")


def bwd_variant(x, Bm, Cm) -> str:
    """The kernel ``ssd_scan_bwd`` launches for x [b,s,h,p] and Bm, Cm
    [b,s,g,n]: ``"tc"`` for the bf16 inputs the forward's tc kernel takes
    (``variant``: p and n multiples of 8, 16-byte aligned x, Bm and Cm with
    batch and sequence strides that are multiples of 8 elements), ``"simt"``
    otherwise (fp32 always: its parity needs IEEE fp32 products)."""
    return variant(x, Bm, Cm)


def bwd_slices(b: int, s: int, g: int, rep: int, sms: int) -> int:
    """The slices the tc backward's chunk pass cuts each group's ``rep``
    heads into, one block each: the fewest (a divisor of ``rep``) that give
    the card's ``sms`` multiprocessors a block each, or ``rep``.  A block
    sums dB and dC over its heads; the wrapper sums the slices."""
    nc = -(-s // CHUNK)
    return next((d for d in range(1, rep + 1) if rep % d == 0 and b * nc * g * d >= sms), rep)


_TC_BWD_ARGTYPES = [_P] * 12 + [_I] * 7 + [_L] * 8 + [_P]


def _launch_bwd(var: str, x, dt, A, Bm, Cm, dy, dstate):
    """Run backward kernel ``var`` on arguments that ``check_bwd_args``
    passed; count nothing.  The kernels write dx and ddt, and in fp32 the
    terms of dA (simt: a (batch, head)'s; tc: a (batch, head, chunk)'s), and
    dB and dC (simt: each head's; tc: each slice of a group's heads); the
    sums over those axes are ``sum``s here, in a fixed order."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    nc = -(-s // CHUNK)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, s, h), dtype=dt.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    strides = (x.stride(0), x.stride(1), dt.stride(0), dt.stride(1), Bm.stride(0), Bm.stride(1),
               Cm.stride(0), Cm.stride(1))
    if var == "tc":
        nsl = bwd_slices(b, s, g, rep, torch.cuda.get_device_properties(dev).multi_processor_count)
        # every chunk's entry state, then its state gradient, as bf16 hi and lo
        # parts, P and N padded to 16 and rows as the kernel's tiles lay them out
        pp, ns = -(-p // 16) * 16, -(-n // 16) * 16 + 8
        states = torch.empty((2, b, h, nc, 2, pp, ns), dtype=torch.bfloat16, device=dev)
        dA_part = torch.empty((b, h, nc), **f32)
        dBC = torch.empty((2, nsl, b, s, g, n), **f32)  # dB, dC summed over a slice's heads
        fn = _build.function("ssd_scan_bwd_tc", "ssd_scan_bwd_tc", _TC_BWD_ARGTYPES)
        with torch.cuda.device(dev):
            err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                     dy.data_ptr(), dstate.data_ptr(), states.data_ptr(), dx.data_ptr(),
                     ddt.data_ptr(), dA_part.data_ptr(), dBC.data_ptr(), b, s, h, g, p, n,
                     nsl, *strides, stream)
        _build.check("ssd_scan_bwd_tc", err)
        return (dx, ddt, dA_part.sum((0, 2)).to(A.dtype), dBC[0].sum(0).to(Bm.dtype),
                dBC[1].sum(0).to(Cm.dtype))
    dA_part = torch.empty((b, h), **f32)
    dB_h, dC_h = torch.empty((b, s, h, n), **f32), torch.empty((b, s, h, n), **f32)
    states = torch.empty((b, h, nc, p, n), **f32)  # each chunk's entry state
    fn = _build.function("ssd_scan_bwd", "ssd_scan_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(_build.DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                 Bm.data_ptr(), Cm.data_ptr(), dy.data_ptr(), dstate.data_ptr(),
                 states.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA_part.data_ptr(),
                 dB_h.data_ptr(), dC_h.data_ptr(), b, s, h, g, p, n, *strides, stream)
    _build.check("ssd_scan_bwd", err)
    return (dx, ddt, dA_part.sum(0).to(A.dtype),
            dB_h.view(b, s, g, rep, n).sum(3).to(Bm.dtype),
            dC_h.view(b, s, g, rep, n).sum(3).to(Cm.dtype))


def ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dstate):
    """The gradient of ``ssd_scan``: the five inputs, dy [b,s,h,p] and dstate
    [b,h,p,n] fp32 -> (dx, ddt, dA, dBm, dCm) in the inputs' dtypes and
    shapes, through the CUDA kernel that ``bwd_variant(x, Bm, Cm)`` names."""
    check_bwd_args(x, dt, A, Bm, Cm, dy, dstate)
    var = bwd_variant(x, Bm, Cm)
    out = _launch_bwd(var, x, dt, A, Bm, Cm, dy, dstate)
    ssd_scan_bwd.launches += 1
    ssd_scan_bwd.variant_launches[var] += 1
    return out


ssd_scan_bwd.launches = 0
ssd_scan_bwd.variant_launches = {"tc": 0, "simt": 0}


# ---------------------------------------------------------------- operator
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("ssd_scan(Tensor x, Tensor dt, Tensor A, Tensor Bm, Tensor Cm) -> (Tensor, Tensor)")
_LIB.impl("ssd_scan", ssd_scan, "CUDA")


def _ssd_scan_cpu(x, dt, A, Bm, Cm):
    y, state = ssd_scan_plain(x, dt, A, Bm, Cm)
    return y.contiguous(), state


_LIB.impl("ssd_scan", _ssd_scan_cpu, "CPU")


@torch.library.register_fake("repro_torch::ssd_scan")
def _ssd_scan_fake(x, dt, A, Bm, Cm):
    b, s, h, p = x.shape
    return (x.new_empty((b, s, h, p)),
            x.new_empty((b, h, p, Bm.shape[3]), dtype=torch.float32))


_LIB.define("ssd_scan_bwd(Tensor x, Tensor dt, Tensor A, Tensor Bm, Tensor Cm, Tensor dy, "
            "Tensor dstate) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")
_LIB.impl("ssd_scan_bwd", ssd_scan_bwd, "CUDA")


def _ssd_scan_bwd_cpu(x, dt, A, Bm, Cm, dy, dstate):
    return tuple(t.contiguous() for t in ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, dstate))


_LIB.impl("ssd_scan_bwd", _ssd_scan_bwd_cpu, "CPU")


@torch.library.register_fake("repro_torch::ssd_scan_bwd")
def _ssd_scan_bwd_fake(x, dt, A, Bm, Cm, dy, dstate):
    return tuple(t.new_empty(t.shape) for t in (x, dt, A, Bm, Cm))
