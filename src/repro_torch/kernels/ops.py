"""Public kernel entry points: ``torch.library`` operators, one per kernel.

Counterpart of ``repro/kernels/ops.py`` (``flash_mha`` :30, ``ssd`` :45,
``fused_rmsnorm`` :52).  Each entry point calls an operator of the
``repro_torch`` namespace (``kernels/rmsnorm.py``, ``flash_attention.py``,
``ssd_scan.py`` define them), and the dispatcher picks the implementation
by the tensor's device: a CPU tensor goes to the kernel's plain PyTorch
version, a CUDA tensor to the Hopper kernel, which launches or raises, a
fake or meta tensor to the fake implementation (shapes only), so a graph
traced by ``core.trace`` holds one node per kernel, as a jaxpr holds one
``pallas_call``.  Nothing falls back from the card to the plain version or
an oracle: the kernels mask ragged tiles and chunks, so the JAX package's
length-based fallbacks are not needed.

``fused_rmsnorm``, ``flash_mha`` and ``ssd`` are differentiable: the
gradients of ``repro_torch::rmsnorm``, ``repro_torch::flash_attention_lse``
and ``repro_torch::ssd_scan`` are registered on the operators and call
``repro_torch::rmsnorm_bwd``, ``repro_torch::flash_attention_bwd`` and
``repro_torch::ssd_scan_bwd`` (the backward kernels on the card, their
plain versions on the CPU).  Attention whose inputs need a gradient
runs the LSE operator, which the backward reads; otherwise it runs the one
without, as serving does, so the kernel writes no LSE.  The flash
gradient takes causal attention with or without a sliding window at head
dims up to 128; ``flash_mha`` refuses any other attention that needs one
(``check_bwd_supported``, NotImplementedError naming ROADMAP B2d) before
its forward runs, on the CPU as on the card.  The JAX kernels have no
backward; the reference differentiates its jnp paths, which compute the
same functions.

``label`` is the counterpart of ``jax.ad_checkpoint.checkpoint_name``: it
names an activation for the planner (``core.offload.KNOWN_NAMES``), and
hands it to an offload policy while one runs a layer (``label_hook``).
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import flash_attention as _flash
from . import rmsnorm as _rms
from . import ssd_scan as _ssd
from .flash_attention import check_bwd_supported

# The CUDA wrappers, each counting its launches in ``.launches``.
KERNELS = (_rms.rmsnorm, _rms.rmsnorm_bwd, _flash.flash_attention, _flash.flash_attention_bwd,
           _ssd.ssd_scan, _ssd.ssd_scan_bwd)
_OPS = torch.ops.repro_torch


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# ---------------------------------------------------------------- gradients
def _rmsnorm_setup(ctx, inputs, output):
    x, scale, eps = inputs
    ctx.save_for_backward(x, scale)
    ctx.eps = eps


def _rmsnorm_backward(ctx, dy):
    x, scale = ctx.saved_tensors
    dx, dscale = _OPS.rmsnorm_bwd(x, scale, dy.contiguous(), ctx.eps)
    return dx, dscale, None


torch.library.register_autograd("repro_torch::rmsnorm", _rmsnorm_backward,
                                setup_context=_rmsnorm_setup)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, window, softcap, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.attn = (causal, window, softcap, scale)
    ctx.mark_non_differentiable(lse)


def _flash_backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _OPS.flash_attention_bwd(q, k, v, out, dout.contiguous(), lse, *ctx.attn)
    return dq, dk, dv, None, None, None, None


torch.library.register_autograd("repro_torch::flash_attention_lse", _flash_backward,
                                setup_context=_flash_setup)


def _ssd_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)  # the kernel recomputes the chunk states from these


def _ssd_backward(ctx, dy, dstate):  # an unused output's gradient comes as zeros
    x, dt, A, Bm, Cm = ctx.saved_tensors
    return _OPS.ssd_scan_bwd(x, dt, A, Bm, Cm, dy.contiguous(), dstate.contiguous())


torch.library.register_autograd("repro_torch::ssd_scan", _ssd_backward, setup_context=_ssd_setup)


# ------------------------------------------------------------- entry points
def flash_mha(q, k, v, *, causal=True, window=None, softcap=None, scale=None):
    """q [B,Sq,H,hd], k/v [B,Sk,KV,hd] -> [B,Sq,H,hd] (blockwise attention).
    Differentiable for causal attention, with or without a window (Sq <=
    Sk), and for unmasked attention without a window at any Sq and Sk, at
    head dims up to 128 and without a softcap; asking for the gradient of
    any other raises NotImplementedError naming B2d."""
    if _needs_grad(q, k, v):
        check_bwd_supported(causal, window, softcap, q.shape[-1], q.shape[1], k.shape[1])
        return _OPS.flash_attention_lse(q, k, v, causal, window, softcap, scale)[0]
    return _OPS.flash_attention(q, k, v, causal, window, softcap, scale)


def ssd(x, dt, A, Bm, Cm):
    """Mamba-2 SSD scan: x [b,s,h,p], dt [b,s,h], A [h], Bm/Cm [b,s,g,n] ->
    (y [b,s,h,p], final state [b,h,p,n] fp32), at any s.  Unlike the JAX
    op, it returns the final state (the decode cache's) and takes no chunk:
    the plain version and both kernels (``tc`` for bf16 whose rows take
    16-byte copies, ``simt`` for fp32 and the other bf16 inputs;
    ``ssd_scan.variant``) chunk by their own 64 steps, which does not change
    the function.  Differentiable in all five inputs, through y and the
    final state: the backward is ``repro_torch::ssd_scan_bwd``, which
    recomputes the chunk states from the inputs, with two kernels routed by
    the same rule (``ssd_scan.bwd_variant``): ``tc`` on the tensor cores
    (state passes over the chunks, then every chunk in parallel), ``simt``
    for fp32 and the other bf16 inputs."""
    return _OPS.ssd_scan(x, dt, A, Bm, Cm)


def fused_rmsnorm(x, scale, *, eps=1e-6):
    """x [..., D], scale [D] fp32 -> like x; differentiable in x and scale."""
    return _OPS.rmsnorm(x, scale, eps)


# ------------------------------------------------------------------- labels
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
# An alias of x by its schema: the tracer reads the name, and the storage is x's.
_LIB.define("label(Tensor(a) x, str name) -> Tensor(a)")
_LIB.impl("label", lambda x, name: x.view(x.shape), "CompositeExplicitAutograd")
torch.library.register_fake("repro_torch::label")(lambda x, name: x.view(x.shape))


class _Label(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        return _OPS.label(x, name)

    @staticmethod
    def backward(ctx, dx):
        return dx, None


# The hook ``label`` hands real tensors to on this thread (``label_hook``).
_HOOK = threading.local()


@contextlib.contextmanager
def label_hook(hook):
    """While active on the current thread, ``label(x, name)`` on a real
    tensor returns ``hook(x, name)``: how an offload policy
    (``core/offload_exec.py``) sees the labelled activations of the layer it
    runs.  A plain attribute on a thread-local, so ``label`` costs no
    dispatch with a hook or without one."""
    prev = getattr(_HOOK, "fn", None)
    _HOOK.fn = hook
    try:
        yield
    finally:
        _HOOK.fn = prev


def label(x, name: str):
    """Name activation ``x`` ``name`` for the planner, as the reference's
    ``checkpoint_name`` does.  On a real tensor it returns ``x`` itself (no
    copy, no launch, no dispatch), or what the ``label_hook`` active on this
    thread returns for it.  On a fake tensor (``core.trace`` tracing a step)
    it records the operator ``repro_torch::label``, a view of ``x`` whose
    node the tracer reads as the start of a variable of that name."""
    if isinstance(x, FakeTensor):
        return _Label.apply(x, name)
    hook = getattr(_HOOK, "fn", None)
    return x if hook is None else hook(x, name)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel wrapper, and of each by variant
    (``rmsnorm/vector``, ``flash_attention/wgmma``, ``rmsnorm_bwd/vector``,
    ``flash_attention_bwd/simt``, ``ssd_scan/tc``, ``ssd_scan_bwd/tc``,
    ``ssd_scan_bwd/simt``, ...), which sum to the wrapper's own count."""
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
