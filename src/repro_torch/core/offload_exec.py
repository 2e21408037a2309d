"""Executing an ``OffloadPlan``: the port's counterpart of the reference's
``save_and_offload_only_these_names(..., offload_dst="pinned_host")``
(``repro/core/offload.py:35-43``), applied per layer under remat.

``OffloadPlan.policy()`` returns an ``OffloadPolicy``, and
``Model.loss(remat_policy=)`` runs each layer through its ``run_layer``: a
``torch.autograd.Function`` that owns its saved input, so nothing here
depends on how ``torch.utils.checkpoint`` holds its inputs, which differs
between torch versions.  For one layer:

  forward   the layer runs under ``no_grad``.  ``ops.label`` hands each
            labelled activation to the policy (``ops.label_hook``): one of
            an offloaded name is copied to a pinned host buffer on the
            device-to-host stream as soon as it exists; one of a saved name
            is kept on the device; the rest is dropped.  The layer's input
            (``block_in``) stays on the device for the backward unless its
            name is offloaded;
  backward  the host-to-device copies of the layer's activations are issued
            when the layer above begins its backward (the top layer issues
            its own); the layer waits on their events, recomputes under
            ``enable_grad`` from its input, continuing from the fetched or
            saved copy where the recompute reaches a label of that name,
            and returns the gradients of its input and its parameters.

A layer may return a tuple, as ``transformer.train_layer`` returns (x,
aux): every output is carried out of the forward, and the backward takes
the gradient of the recomputed outputs against the gradients that reach
them, skipping those with none (a None output, such as a dense layer's
aux) and those the recompute does not differentiate.  A single-output layer
takes exactly the path it took before.  Every tensor the layer reads
besides its input and may need a gradient of goes in its ``params``: a
decoder layer's encoder output too (``encdec.EncDecModel.loss``), which is
how the cross attentions' gradient reaches the encoder; a tensor ``fn``
only closed over would get none.

Everything else is recomputed, as under plain remat, so each kernel
launches as often as there: each forward twice, each backward once.  This
is the paper's swap execution (§IV): swap out after the last forward access
and prefetch before the backward access, on two streams, one a direction;
each use waits on an event, never on the whole device.

A device tensor that a copy still reads is marked in use by the copy's
stream (``record_stream``), so the caching allocator does not hand its block
out before the copy ends.  A host buffer is written again only after the
host-to-device copy that read it has ended (an event); buffers are pinned
once and reused across steps.  ``bytes_d2h`` and ``bytes_h2d`` count the
bytes moved each way.  CPU tensors take the same path with plain copies into
host buffers and no streams: the port's CPU path, as each kernel has one.
"""

from __future__ import annotations

from functools import partial

import torch

from repro_torch.kernels.ops import label_hook

# The label of a layer's input (the reference's unit input,
# ``repro/models/transformer.py:319``).
INPUT_NAME = "block_in"


class _HostBuffer:
    """A host copy of one activation, with the events of the copy that wrote
    it (``written``) and of the last copy that read it (``read``)."""

    __slots__ = ("tensor", "key", "written", "read")

    def __init__(self, tensor, key):
        self.tensor, self.key = tensor, key
        self.written = self.read = None


class _LayerStash:
    """What one layer keeps between its forward and its backward."""

    __slots__ = ("below", "device", "input_host", "kept", "fetched", "done")

    def __init__(self, below, device):
        self.below = below          # the layer run before it, whose backward comes next
        self.device = device
        self.input_host = None      # the input's host buffer, when block_in is offloaded
        self.kept = []              # per offloaded or saved label: a host buffer or a tensor
        self.fetched = None         # (input, [kept]) on the device, each beside its event
        self.done = False


def _ready(t, event):
    """``t`` once ``event`` has passed on the current stream (no wait for None)."""
    if event is not None:
        torch.cuda.current_stream(t.device).wait_event(event)
    return t


class OffloadPolicy:
    """Runs layers under remat, offloading the activations labelled with
    ``offload_names`` to host memory and keeping those labelled with
    ``save_names`` on the device (``run_layer``)."""

    def __init__(self, offload_names, save_names=()):
        self.offload_names = frozenset(offload_names)
        self.save_names = frozenset(save_names) - self.offload_names
        self.bytes_d2h = 0
        self.bytes_h2d = 0
        self._free: dict[tuple, list[_HostBuffer]] = {}
        self._streams: dict[torch.device, tuple] = {}
        self._last: _LayerStash | None = None

    def run_layer(self, fn, x, params):
        """``fn(x)``: one layer that reads ``params`` (its parameters, and any
        other tensor whose gradient it owes, such as an encoder's output),
        recomputed in backward, with this policy's offloads; ``fn`` returns
        a tensor or a tuple of tensors and Nones.  Without a gradient to
        take it is ``fn(x)`` alone."""
        if not torch.is_grad_enabled() or not (x.requires_grad
                                               or any(p.requires_grad for p in params)):
            return fn(x)
        return _OffloadedLayer.apply(self, fn, x, *params)

    # ---------------------------------------------------------- the forward
    def _open(self, device) -> _LayerStash:
        below = self._last if self._last is not None and not self._last.done else None
        self._last = _LayerStash(below, device)
        return self._last

    def _stash(self, stash: _LayerStash, x, name: str):
        if name == INPUT_NAME:
            if name in self.offload_names:
                stash.input_host = self._to_host(x)
        elif name in self.offload_names:
            stash.kept.append(self._to_host(x))
        elif name in self.save_names:
            stash.kept.append(x)
        return x

    def _streams_of(self, device):
        """(device-to-host, host-to-device) side streams of ``device``."""
        if device not in self._streams:
            self._streams[device] = (torch.cuda.Stream(device), torch.cuda.Stream(device))
        return self._streams[device]

    def _to_host(self, x) -> _HostBuffer:
        key = (tuple(x.shape), x.dtype, x.device)
        free = self._free.get(key)
        buf = free.pop() if free else _HostBuffer(
            torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda), key)
        if x.is_cuda:
            d2h, _ = self._streams_of(x.device)
            d2h.wait_stream(torch.cuda.current_stream(x.device))  # x exists
            if buf.read is not None:
                d2h.wait_event(buf.read)                          # the last step read it back
            with torch.cuda.stream(d2h):
                buf.tensor.copy_(x, non_blocking=True)
            buf.written = torch.cuda.Event()
            buf.written.record(d2h)
            x.record_stream(d2h)
        else:
            buf.tensor.copy_(x)
        self.bytes_d2h += x.numel() * x.element_size()
        return buf

    # --------------------------------------------------------- the backward
    def _to_device(self, buf: _HostBuffer, device):
        host = buf.tensor
        out = torch.empty(host.shape, dtype=host.dtype, device=device)
        if device.type == "cuda":
            _, h2d = self._streams_of(device)
            h2d.wait_stream(torch.cuda.current_stream(device))  # earlier work on out's block
            h2d.wait_event(buf.written)
            with torch.cuda.stream(h2d):
                out.copy_(host, non_blocking=True)
            ready = buf.read = torch.cuda.Event()
            ready.record(h2d)
        else:
            out.copy_(host)
            ready = None
        self.bytes_h2d += out.numel() * out.element_size()
        self._free.setdefault(buf.key, []).append(buf)
        return out, ready

    def _fetch(self, stash: _LayerStash) -> None:
        """Issue the host-to-device copies of ``stash``'s layer, once."""
        if stash.fetched is not None or stash.done:
            return
        inp = None if stash.input_host is None else self._to_device(stash.input_host,
                                                                    stash.device)
        kept = [self._to_device(k, stash.device) if isinstance(k, _HostBuffer) else (k, None)
                for k in stash.kept]
        stash.fetched, stash.input_host, stash.kept = (inp, kept), None, []

    def _replay(self, kept, x, name: str):
        if name == INPUT_NAME or name not in self.offload_names | self.save_names:
            return x
        return _Continue.apply(x, next(kept))


class _Continue(torch.autograd.Function):
    """The stored copy's value in place of the recomputed ``t``; the gradient
    goes to ``t``."""

    @staticmethod
    def forward(ctx, t, stored):
        return stored.detach()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _OffloadedLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, policy, fn, x, *params):
        stash = policy._open(x.device)
        with label_hook(partial(policy._stash, stash)):
            y = fn(x)
        ctx.policy, ctx.fn, ctx.stash, ctx.params = policy, fn, stash, params
        ctx.save_for_backward(x if stash.input_host is None else None)
        ctx.set_materialize_grads(False)  # an unused output's gradient stays None
        return y

    @staticmethod
    def backward(ctx, *dys):
        policy, stash = ctx.policy, ctx.stash
        policy._fetch(stash)
        if stash.below is not None:
            policy._fetch(stash.below)
        inp, kept = stash.fetched
        x = ctx.saved_tensors[0] if inp is None else _ready(*inp)
        kept = iter([_ready(*k) for k in kept])
        stash.fetched, stash.below, stash.done = None, None, True
        x = x.detach().requires_grad_(ctx.needs_input_grad[2])
        with torch.enable_grad(), label_hook(partial(policy._replay, kept)):
            ys = ctx.fn(x)
        ys = ys if isinstance(ys, tuple) else (ys,)
        pairs = [(y, dy) for y, dy in zip(ys, dys)
                 if dy is not None and y is not None and y.requires_grad]
        inputs = (x, *ctx.params)
        out = [None] * len(inputs)
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[2:]) if need]
        if pairs:
            grads = torch.autograd.grad([y for y, _ in pairs], [inputs[i] for i in wanted],
                                        [dy for _, dy in pairs], allow_unused=True)
            for i, g in zip(wanted, grads):
                out[i] = g
        return (None, None, *out)
