"""Flash attention: two CUDA forward kernels, a CUDA backward, and plain versions.

Counterpart of ``repro/kernels/flash_attention.py:99 flash_attention`` (a
Pallas TPU kernel).  ``flash_attention`` launches a Hopper kernel on CUDA
tensors: ``variant(dtype, hd)`` names which one, and nothing else decides.

- ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``): bf16 at head dim 64, 128
  or 256, on the tensor cores, tiles of 128 q rows by 128 keys (by 64 keys
  at head dim 256, whose 128-key tiles would not fit in shared memory).  It
  rounds P to bf16 before P.V (the TPU kernel's P.V is fp32; see the source
  note).
- ``"simt"`` (``csrc/flash_attention.cu``): everything else the wrapper takes
  -- fp32 (whose 2e-5 parity needs IEEE fp32 products, not TF32 tensor
  cores) and bf16 at head dims other than 64, 128 and 256 (16 to 240 in
  steps of 16) -- on the CUDA cores, tiles of 64 rows (32 above head dim
  128).

Each launch counts in ``flash_attention.launches`` and in
``flash_attention.variant_launches[variant]``.  A launch that fails raises;
nothing gives way to the other variant or to the plain version.
``_launch(var, ...)`` runs a named variant on inputs the wrapper would
take, counting nothing: the wrapper's own launcher, which ``chip_smoke.py``
also calls to time the ``simt`` kernel beside ``wgmma`` on the same inputs.
``flash_attention_plain`` repeats the kernels' arithmetic in PyTorch (q
tiles, live k tiles at the variant's tile shape, fp32 online softmax with
P kept in fp32, -1e30 masking, rows with no live key give 0) and is what
the CPU runs.  Unlike the TPU kernel, none needs the lengths to divide the
tiles.  The source notes in the ``.cu`` files give each kernel's bound and
design.

With ``return_lse=True`` each forward also returns every row's
log-sum-exp, ``m + log l`` in fp32 [B, H, Sq], which the backward needs;
serving leaves it off, so its kernels write nothing more.

``flash_attention_bwd`` is the gradient of causal attention, with or
without a sliding window, and of unmasked attention (an encoder's self
attention, a decoder's cross attention, at any Sq and Sk), with or without
a tanh softcap, at every head dim the forward takes (up to 256): from q, k,
v, the output o, dO and the LSE it returns dq, dk and dv in q's dtype,
recomputing P from the LSE.  With a softcap c the scores are capped as the
forward caps them, s = c tanh(scale q.k / c) = c t, so P = exp(c t - lse)
and dS = P (dP - D) (1 - t^2).  ``check_bwd_supported`` is the one place
that decides what the gradient takes, on every device: it refuses a window
with Sq > Sk (rows left without a live key) and unmasked attention with a
window with NotImplementedError naming ROADMAP B2d, before any kernel or
plain code runs.  The window only narrows each kernel block's tile range
and adds ``q - k < window`` to the masks; unmasked attention widens the
ranges to every tile and keeps only the ragged edges' masks.  The kernels
take both, and the softcap, as arguments beside the tensors (``int causal,
int window``, ``float softcap``, 0 for none).  ``bwd_variant`` names its
kernel: ``"wgmma"`` (``csrc/flash_attention_bwd_wgmma.cu``: bf16 at head
dim 64, 128 or 256 with 16-byte aligned tensors, on Hopper's warpgroup
MMA; it rounds P and dS to bf16 where they enter a product, as the wgmma
forward rounds P) or ``"simt"`` (``csrc/flash_attention_bwd.cu``: fp32,
and bf16 at other head dims, on the CUDA cores, in tiles of 64 rows up to
head dim 128 and 32 above, as the forward's).  That file's ``"mma"``
variant (``mma.sync``, the same function as ``wgmma`` at head dim 64 and
128 without a softcap) is routed nowhere and is kept as the yardstick that
``_launch_bwd`` runs on request.  It counts in
``flash_attention_bwd.launches`` and ``.variant_launches``.
``flash_attention_bwd_plain`` computes the same in PyTorch, in fp32.

Three ``torch.library`` operators carry them: ``repro_torch.flash_attention``
(the output alone: serving's instantiation, which writes no LSE),
``repro_torch.flash_attention_lse`` (the output and the LSE: training's)
and ``repro_torch.flash_attention_bwd``, which takes the forward's own
arguments (causal, window, softcap, scale).  The dispatcher
sends a CUDA tensor to the wrappers above (the kernel, or a raise), a CPU
tensor to the plain versions, and a fake or meta tensor to a fake
implementation that returns the real outputs' shapes, dtypes and strides
and reads no address (``variant`` and ``bwd_variant`` read addresses, so
they run only in the wrappers).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
WGMMA_HEAD_DIMS = (64, 128, 256)


def variant(dtype: torch.dtype, hd: int) -> str:
    """The kernel ``flash_attention`` launches for q/k/v of ``dtype`` and head
    dim ``hd``: ``"wgmma"`` for bf16 at hd 64, 128 or 256, ``"simt"``
    otherwise."""
    return "wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS else "simt"


def block_shape(dtype: torch.dtype, hd: int) -> tuple[int, int]:
    """(q rows, keys) of a tile of the kernel that ``variant`` picks.  The tile
    decides which fully masked rows (window with Sq > Sk) meet a live k tile
    and so give a uniform average rather than 0, so the plain version tiles
    as the kernel does."""
    if variant(dtype, hd) == "wgmma":
        return 128, 128 if hd <= 128 else 64  # ``Tiles`` in csrc/flash_attention_wgmma.cu
    t = 64 if hd <= 128 else 32  # ``dispatch`` in csrc/flash_attention.cu
    return t, t


_I, _P = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I,
             ctypes.c_float, _P]
_BWD_ARGTYPES = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                 ctypes.c_float, ctypes.c_float, _P]
BWD_NOT_PORTED = "is not yet ported, see ROADMAP.md queue B item 2 (B2d)"


def flash_attention_plain(q, k, v, *, causal=True, window=None, softcap=None, scale=None,
                          return_lse=False):
    """q [B,Sq,H,hd], k/v [B,Sk,KV,hd] -> [B,Sq,H,hd] in q's dtype, and with
    ``return_lse`` also each row's m + log l, fp32 [B,H,Sq]."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd**-0.5
    bq, bk = block_shape(q.dtype, hd)
    qf = q.float().transpose(1, 2)                                   # [B,H,Sq,hd]
    kf = k.float().repeat_interleave(H // KV, dim=2).transpose(1, 2)  # [B,H,Sk,hd]
    vf = v.float().repeat_interleave(H // KV, dim=2).transpose(1, 2)
    out = torch.empty_like(qf)
    lse = torch.empty((B, H, Sq), device=q.device)
    for q0 in range(0, Sq, bq):
        q1 = min(q0 + bq, Sq)
        q_pos = torch.arange(q0, q1, device=q.device)[:, None]
        m = torch.full((B, H, q1 - q0, 1), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, H, q1 - q0, hd), device=q.device)
        k_end = min(Sk, q1) if causal else Sk
        k_begin = max(0, q0 - window + 1) if window is not None else 0
        for k0 in range(k_begin // bk * bk, k_end, bk):
            k1 = min(k0 + bk, Sk)
            s = qf[:, :, q0:q1] @ kf[:, :, k0:k1].transpose(-1, -2) * scale
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            k_pos = torch.arange(k0, k1, device=q.device)[None, :]
            keep = torch.ones_like(s[0, 0], dtype=torch.bool)
            if causal:
                keep &= q_pos >= k_pos
            if window is not None:
                keep &= q_pos - k_pos < window
            s = torch.where(keep, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p @ vf[:, :, k0:k1]
            m = m_new
        out[:, :, q0:q1] = acc / torch.where(l == 0, 1.0, l)
        lse[:, :, q0:q1] = (m + torch.log(l))[..., 0]
    out = out.transpose(1, 2).to(q.dtype)
    return (out, lse) if return_lse else out


def check_args(q, k, v, window) -> None:
    """Raise ValueError on what the kernel does not take."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: want q [B,Sq,H,hd], k = v [B,Sk,KV,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Bk, Sk, KV, hdk = k.shape
    if Bk != B or hdk != hd or H % KV or min(B, Sq, Sk, H, KV) < 1:
        raise ValueError(f"flash_attention: mismatched shapes {tuple(q.shape)}, {tuple(k.shape)}")
    if hd % 16 or hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim must be a multiple of 16 up to "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if variant(q.dtype, hd) == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the wgmma kernel loads 16-byte chunks, so q, k and "
                         "v must start at 16-byte aligned addresses")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: the kernel takes CUDA tensors on one device, got "
                         f"{q.device}, {k.device}, {v.device}")


def _launch(var: str, q, k, v, *, causal=True, window=None, softcap=None, scale=None,
            return_lse=False):
    """Run forward kernel ``var`` (``"wgmma"`` or ``"simt"``) on arguments that
    ``check_args`` passed; count nothing."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd**-0.5
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), device=q.device) if return_lse else None
    lib = "flash_attention_wgmma" if var == "wgmma" else "flash_attention"
    fn = _build.function(lib, f"{lib}_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), None if lse is None else lse.data_ptr(), B, Sq, Sk, H, KV, hd,
                 float(scale), int(causal), window or 0, float(softcap or 0.0),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err)
    return (out, lse) if return_lse else out


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None, scale=None,
                    return_lse=False):
    """q [B,Sq,H,hd], k/v [B,Sk,KV,hd] -> [B,Sq,H,hd], through the CUDA kernel
    that ``variant(q.dtype, hd)`` names; with ``return_lse`` also the rows'
    log-sum-exp, fp32 [B,H,Sq]."""
    check_args(q, k, v, window)
    var = variant(q.dtype, q.shape[-1])
    out = _launch(var, q, k, v, causal=causal, window=window, softcap=softcap, scale=scale,
                  return_lse=return_lse)
    flash_attention.launches += 1
    flash_attention.variant_launches[var] += 1
    return out


flash_attention.launches = 0
flash_attention.variant_launches = {"wgmma": 0, "simt": 0}


# ---------------------------------------------------------------- backward
def check_bwd_supported(causal, window, softcap, hd: int, sq: int, sk: int) -> None:
    """Raise NotImplementedError for attention whose gradient is not ported,
    on every device alike: it takes causal attention, with or without a
    ``window`` (then Sq <= Sk, so that every row keeps a live key), and
    unmasked attention without a window at any Sq and Sk, with or without a
    ``softcap``, at head dims up to ``MAX_HEAD_DIM``, every one the forward
    kernels take."""
    why = None
    if hd > MAX_HEAD_DIM:
        why = f"head dim {hd} (above {MAX_HEAD_DIM}, which no forward kernel takes either)"
    elif window is not None and not causal:
        why = f"unmasked attention with a window ({window})"
    elif window is not None and sq > sk:
        why = f"a window with Sq {sq} > Sk {sk} (rows with no live key)"
    if why:
        raise NotImplementedError(
            f"the gradient of attention with {why} {BWD_NOT_PORTED}: it is ported for causal "
            f"attention, with or without a window, and unmasked attention without one, with or "
            f"without a softcap, at head dims up to {MAX_HEAD_DIM}")


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal=True, window=None, softcap=None,
                              scale=None):
    """The gradient of causal attention, with or without a window, or of
    unmasked attention, with or without a softcap, in fp32: q, o, do
    [B,Sq,H,hd], k/v [B,Sk,KV,hd], lse [B,H,Sq] fp32 -> (dq, dk, dv) in q's
    dtype.  P is recomputed from the LSE, as the kernel does; D = rowsum(dO
    * o) uses the forward's output as given.  With a softcap c, t = tanh(s /
    c) of the scaled scores s, P = exp(c t - lse) and dS = P (dP - D) (1 -
    t^2)."""
    check_bwd_supported(causal, window, softcap, q.shape[-1], q.shape[1], k.shape[1])
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else hd**-0.5
    qf = q.float().transpose(1, 2)                                   # [B,H,Sq,hd]
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)        # [B,H,Sk,hd]
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    dof = do.float().transpose(1, 2)
    offset = (torch.arange(Sq, device=q.device)[:, None]
              - torch.arange(Sk, device=q.device)[None, :])
    live = offset >= 0 if causal else torch.ones_like(offset, dtype=torch.bool)
    if window is not None:
        live &= offset < window
    s = qf @ kf.transpose(-1, -2) * scale
    if softcap:
        t = torch.tanh(s / softcap)
        s = softcap * t
    p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
    delta = (dof * o.float().transpose(1, 2)).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    if softcap:
        ds = ds * (1 - t * t)
    dq = ds @ kf * scale
    dk = (ds.transpose(-1, -2) @ qf * scale).view(B, KV, G, Sk, hd).sum(2)
    dv = (p.transpose(-1, -2) @ dof).view(B, KV, G, Sk, hd).sum(2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(q.dtype),
            dv.transpose(1, 2).to(q.dtype))


def check_bwd_args(q, k, v, o, do, lse, window) -> None:
    """Raise ValueError on what the backward kernel does not take
    (``check_bwd_supported`` has refused what it does not compute)."""
    check_args(q, k, v, window)
    B, Sq, H, hd = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or not t.is_contiguous() or \
                t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must be contiguous {q.dtype} "
                             f"{tuple(q.shape)} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or not lse.is_contiguous() or \
            lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse must be contiguous float32 {(B, H, Sq)} on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")


def bwd_variant(o, do) -> str:
    """The kernel ``flash_attention_bwd`` launches: ``"wgmma"`` for bf16 at
    head dim 64, 128 or 256 when o and dO start 16-byte aligned
    (``check_bwd_args`` requires q, k and v to, as the forward does there),
    ``"simt"`` otherwise."""
    aligned = o.data_ptr() % 16 == 0 and do.data_ptr() % 16 == 0
    wgmma = o.dtype == torch.bfloat16 and o.shape[-1] in WGMMA_HEAD_DIMS
    return "wgmma" if wgmma and aligned else "simt"


def _launch_bwd(var: str, q, k, v, o, do, lse, scale: float, window=None, causal=True,
                softcap=None):
    """Run backward kernel ``var`` (``"wgmma"``, ``"mma"`` or ``"simt"``) on
    arguments that ``check_bwd_args`` passed; count nothing."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (_build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr())
    lib = "flash_attention_bwd_wgmma" if var == "wgmma" else "flash_attention_bwd"
    symbol = {"wgmma": lib, "mma": "flash_attention_bwd_mma"}.get(var, "flash_attention_bwd")
    fn = _build.function(lib, symbol, _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(*args, B, Sq, Sk, H, KV, hd, int(causal), window or 0, float(scale),
                 float(softcap or 0.0), stream)
    _build.check(lib, err)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, do, lse, *, causal=True, window=None, softcap=None,
                        scale=None):
    """The gradient of causal attention, with or without a window, or of
    unmasked attention, with or without a softcap, through the kernel that
    ``bwd_variant`` names: -> (dq, dk, dv), each like its input."""
    check_bwd_supported(causal, window, softcap, q.shape[-1], q.shape[1], k.shape[1])
    check_bwd_args(q, k, v, o, do, lse, window)
    scale = scale if scale is not None else q.shape[-1]**-0.5
    var = bwd_variant(o, do)
    out = _launch_bwd(var, q, k, v, o, do, lse, scale, window, causal, softcap)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.variant_launches[var] += 1
    return out


flash_attention_bwd.launches = 0
flash_attention_bwd.variant_launches = {"wgmma": 0, "mma": 0, "simt": 0}


# ---------------------------------------------------------------- operators
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_ATTN_ARGS = "Tensor q, Tensor k, Tensor v, bool causal, int? window, float? softcap, float? scale"
_LIB.define(f"flash_attention({_ATTN_ARGS}) -> Tensor")
_LIB.define(f"flash_attention_lse({_ATTN_ARGS}) -> (Tensor, Tensor)")
_LIB.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor do, Tensor lse, "
            "bool causal, int? window, float? softcap, float? scale) -> (Tensor, Tensor, Tensor)")


def _forward(fn, return_lse: bool):
    """An operator's implementation by ``fn``: the kernel's output is
    contiguous, the plain version's made so (the fake's strides)."""
    def impl(q, k, v, causal, window, softcap, scale):
        out = fn(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale,
                 return_lse=return_lse)
        return (out[0].contiguous(), out[1]) if return_lse else out.contiguous()
    return impl


for _name, _lse in (("flash_attention", False), ("flash_attention_lse", True)):
    _LIB.impl(_name, _forward(flash_attention, _lse), "CUDA")
    _LIB.impl(_name, _forward(flash_attention_plain, _lse), "CPU")


def _backward(fn):
    """The backward operator's implementation by ``fn``, outputs contiguous."""
    def impl(q, k, v, o, do, lse, causal, window, softcap, scale):
        return tuple(t.contiguous() for t in fn(q, k, v, o, do, lse, causal=causal, window=window,
                                                softcap=softcap, scale=scale))
    return impl


_LIB.impl("flash_attention_bwd", _backward(flash_attention_bwd), "CUDA")
_LIB.impl("flash_attention_bwd", _backward(flash_attention_bwd_plain), "CPU")


@torch.library.register_fake("repro_torch::flash_attention")
def _flash_fake(q, k, v, causal, window, softcap, scale):
    return q.new_empty(q.shape)


@torch.library.register_fake("repro_torch::flash_attention_lse")
def _flash_lse_fake(q, k, v, causal, window, softcap, scale):
    B, Sq, H, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, Sq), dtype=torch.float32)


@torch.library.register_fake("repro_torch::flash_attention_bwd")
def _flash_bwd_fake(q, k, v, o, do, lse, causal, window, softcap, scale):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)
