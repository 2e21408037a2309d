"""Public kernel entry points: the tensor's device picks the implementation.

Counterpart of ``repro/kernels/ops.py`` (``flash_mha`` :30, ``ssd`` :45,
``fused_rmsnorm`` :52).  A CPU tensor goes to the kernel's plain PyTorch
version; a CUDA tensor goes to the Hopper kernel, which launches or raises.
Nothing falls back from the card to the plain version or an oracle: the
kernels mask ragged tiles and chunks, so the JAX package's length-based
fallbacks are not needed.

``fused_rmsnorm`` and ``flash_mha`` are differentiable: when an input needs
a gradient they run through a ``torch.autograd.Function`` whose forward is
the device-routed forward (flash also returning the LSE) and whose backward
is the device-routed backward (``rmsnorm_bwd``, ``flash_attention_bwd``;
their plain versions on the CPU).  The JAX kernels have no backward; the
reference differentiates its jnp paths, which compute the same functions.
Without a gradient to take, the forward runs alone, as serving does.
"""

from __future__ import annotations

import torch

from .flash_attention import (check_bwd_supported, flash_attention, flash_attention_bwd,
                              flash_attention_bwd_plain, flash_attention_plain)
from .rmsnorm import rmsnorm, rmsnorm_bwd, rmsnorm_bwd_plain, rmsnorm_plain
from .ssd_scan import ssd_scan, ssd_scan_plain

# The CUDA wrappers, each counting its launches in ``.launches``.
KERNELS = (rmsnorm, rmsnorm_bwd, flash_attention, flash_attention_bwd, ssd_scan)


def _on_cpu(x) -> bool:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {x.device}")
    return x.device.type == "cpu"


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _FlashMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        fn = flash_attention_plain if _on_cpu(q) else flash_attention
        out, lse = fn(q, k, v, causal=True, scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        fn = flash_attention_bwd_plain if _on_cpu(q) else flash_attention_bwd
        dq, dk, dv = fn(q, k, v, out, dout.contiguous(), lse, scale=ctx.scale)
        return dq, dk, dv, None


def flash_mha(q, k, v, *, causal=True, window=None, softcap=None, scale=None):
    """q [B,Sq,H,hd], k/v [B,Sk,KV,hd] -> [B,Sq,H,hd] (blockwise attention).
    Differentiable for causal attention without window or softcap; taking
    the gradient of any other raises NotImplementedError."""
    if _needs_grad(q, k, v):
        check_bwd_supported(causal, window, softcap)
        return _FlashMHA.apply(q, k, v, scale)
    fn = flash_attention_plain if _on_cpu(q) else flash_attention
    return fn(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)


def ssd(x, dt, A, Bm, Cm):
    """Mamba-2 SSD scan: x [b,s,h,p], dt [b,s,h], A [h], Bm/Cm [b,s,g,n] ->
    (y [b,s,h,p], final state [b,h,p,n] fp32), at any s.  Unlike the JAX
    op, it returns the final state (the decode cache's) and takes no chunk:
    the plain version and both kernels (``tc`` for bf16 whose rows take
    16-byte copies, ``simt`` for fp32 and the other bf16 inputs;
    ``ssd_scan.variant``) chunk by their own 64 steps, which does not change
    the function.  Forward only: its gradient waits for mamba2 training."""
    fn = ssd_scan_plain if _on_cpu(x) else ssd_scan
    return fn(x, dt, A, Bm, Cm)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_plain(x, scale, eps) if _on_cpu(x) else rmsnorm(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dy = dy.contiguous()
        if _on_cpu(x):
            dx, dscale = rmsnorm_bwd_plain(x, scale, dy, ctx.eps)
        else:
            dx, dscale = rmsnorm_bwd(x, scale, dy, eps=ctx.eps)
        return dx, dscale, None


def fused_rmsnorm(x, scale, *, eps=1e-6):
    """x [..., D], scale [D] fp32 -> like x; differentiable in x and scale."""
    if _needs_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps)
    if _on_cpu(x):
        return rmsnorm_plain(x, scale, eps)
    return rmsnorm(x, scale, eps=eps)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel wrapper, and of each by variant
    (``rmsnorm/vector``, ``flash_attention/wgmma``, ``rmsnorm_bwd/vector``,
    ``flash_attention_bwd/simt``, ``ssd_scan/tc``, ...), which sum to the
    wrapper's own count."""
    counts = {}
    for fn in KERNELS:
        counts[fn.__name__] = fn.launches
        for var, n in fn.variant_launches.items():
            counts[f"{fn.__name__}/{var}"] = n
    return counts


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
        for var in fn.variant_launches:
            fn.variant_launches[var] = 0
