"""Public kernel entry points: the tensor's device picks the implementation.

Counterpart of ``repro/kernels/ops.py`` (``flash_mha`` :30, ``ssd`` :45,
``fused_rmsnorm`` :52).  A CPU tensor goes to the kernel's plain PyTorch
version; a CUDA tensor goes to the Hopper kernel, which launches or raises.
Nothing falls back from the card to the plain version or an oracle: the
kernels mask ragged tiles and chunks, so the JAX package's length-based
fallbacks are not needed.
"""

from __future__ import annotations

from .flash_attention import flash_attention, flash_attention_plain
from .rmsnorm import rmsnorm, rmsnorm_plain
from .ssd_scan import ssd_scan, ssd_scan_plain

# The CUDA wrappers, each counting its launches in ``.launches``.
KERNELS = (rmsnorm, flash_attention, ssd_scan)


def _on_cpu(x) -> bool:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {x.device}")
    return x.device.type == "cpu"


def flash_mha(q, k, v, *, causal=True, window=None, softcap=None, scale=None):
    """q [B,Sq,H,hd], k/v [B,Sk,KV,hd] -> [B,Sq,H,hd] (blockwise attention)."""
    fn = flash_attention_plain if _on_cpu(q) else flash_attention
    return fn(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)


def ssd(x, dt, A, Bm, Cm):
    """Mamba-2 SSD scan: x [b,s,h,p], dt [b,s,h], A [h], Bm/Cm [b,s,g,n] ->
    (y [b,s,h,p], final state [b,h,p,n] fp32), at any s.  Unlike the JAX
    op, it returns the final state (the decode cache's) and takes no chunk:
    the plain version and both kernels (``tc`` for bf16 whose rows take
    16-byte copies, ``simt`` for fp32 and the other bf16 inputs;
    ``ssd_scan.variant``) chunk by their own 64 steps, which does not change
    the function."""
    fn = ssd_scan_plain if _on_cpu(x) else ssd_scan
    return fn(x, dt, A, Bm, Cm)


def fused_rmsnorm(x, scale, *, eps=1e-6):
    """x [..., D], scale [D] fp32 -> like x."""
    if _on_cpu(x):
        return rmsnorm_plain(x, scale, eps)
    return rmsnorm(x, scale, eps=eps)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel wrapper, and of each by variant
    (``rmsnorm/vector``, ``flash_attention/wgmma``, ``ssd_scan/tc``, ...),
    which sum to the wrapper's own count."""
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
