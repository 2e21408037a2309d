"""Fault-tolerant checkpointing: atomic, async, keep-k (counterpart of
``repro/checkpoint/manager.py``).

Layout, the reference's:  <dir>/step_<N>/  shard_0.npz  +  MANIFEST.json
(``{"step", "num_leaves", "keys", "format": 1}``).  Writes go to
``step_<N>.tmp``, the shard and the manifest are fsynced, and only then is
the directory renamed (and its parent fsynced), so a process dying
mid-write never corrupts the latest checkpoint: ``latest_step`` skips
``.tmp`` directories and directories without a manifest.  The reference
fsyncs only the manifest.

Keys are the reference's: the ``"/"``-joined path of dict keys and list or
tuple indices, with ``AdamWState`` flattened as ``(m, v, count)``, so
``(params, opt)`` gives ``0/...``, ``1/0/...``, ``1/1/...`` and ``1/2``.
A tree of nested dicts and lists of numpy arrays is written with the same
keys and the same manifest bytes under either manager, and each restores
the other's.  ``None`` is an empty subtree, as in JAX.

Leaves are tensors, numpy arrays or Python scalars.  numpy has no bf16, so
a bf16 tensor is stored widened to fp32, which is exact; restoring it into
a bf16 template takes the high half of each fp32 word back, bit for bit
(NaN payloads included), and casts by value only an fp32 array that was
not written that way.  ``restore`` casts each leaf to the template's dtype
and places it on the template's device (or on ``device``): a checkpoint
written from the card restores on the CPU.  A Python int (``AdamWState``'s
count) comes back as an int.

``async_save`` returns once the tree's snapshot is enqueued: each device
tensor is copied into a pinned host buffer (kept and reused from save to
save) on its device's current stream, and an event is recorded after the
copies; the writer thread waits on that event and never reads a device
tensor.  The train step that follows writes params, m and v in place on the
same stream, after the copies.  ``wait()`` joins the writer before the next
save or at exit and raises what it raised.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWState


def _rebuild(fn, tree, path: tuple = ()):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``, in the
    template's own order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, AdamWState):
        return AdamWState(*(_rebuild(fn, c, path + (i,))
                            for i, c in enumerate((tree.m, tree.v, tree.count))))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn("/".join(str(p) for p in path), tree)


def _flatten(tree) -> list[tuple[str, Any]]:
    """(key, leaf) of every leaf of ``tree``, in its own order."""
    out = []
    _rebuild(lambda key, leaf: out.append((key, leaf)), tree)
    return out


def _to_numpy(leaf) -> np.ndarray:
    """A host tensor, numpy array or scalar as the array that is written:
    bf16 widened to fp32 (exact), every other dtype as it is."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        return (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).numpy()
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, like, device=None, key: str = ""):
    """``arr``, the checkpoint's leaf ``key``, as the template leaf ``like``:
    its dtype, on its device (or ``device``); an int, float or bool for a
    Python scalar.  A 2-byte void
    array (``|V2``: how ``np.savez`` writes the reference's ml_dtypes bf16)
    is read as the bits of a bf16 template and refused under any other."""
    if isinstance(like, torch.Tensor):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint shape {arr.shape}, template {tuple(like.shape)}")
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            if like.dtype != torch.bfloat16:
                raise ValueError(f"checkpoint leaf {key!r} is {arr.dtype.str} (bf16 bits), "
                                 f"template {like.dtype}")
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
            dev = like.device if device is None else torch.device(device)
            return t.to(device=dev)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if like.dtype == torch.bfloat16 and t.dtype == torch.float32:
            bits = t.view(torch.int32)
            if not (bits & 0xFFFF).any():  # written widened from bf16: take the high half
                t = (bits >> 16).to(torch.int16).view(torch.bfloat16)
        dev = like.device if device is None else torch.device(device)
        return t.to(device=dev, dtype=like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr.item())
    return arr.astype(np.asarray(like).dtype)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write(flat: dict[str, np.ndarray], directory: str, step: int) -> str:
    """Write host arrays as step ``step``, atomically; returns its directory."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "shard_0.npz"), "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    manifest = {"step": step, "num_leaves": len(flat), "keys": sorted(flat), "format": 1}
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(directory)
    return final


def save_pytree(tree, directory: str, step: int) -> str:
    """Atomic synchronous save; returns the final directory."""
    os.makedirs(directory, exist_ok=True)
    return _write({k: _to_numpy(v.cpu() if isinstance(v, torch.Tensor) else v)
                   for k, v in _flatten(tree)}, directory, step)


def restore_pytree(template, directory: str, step: int | None = None, *, device=None):
    """Restore into the structure, dtypes and devices of ``template``, whose
    tensor leaves may be meta tensors when ``device`` says where the restored
    ones go.  Returns (tree, step)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    n = len(_flatten(template))
    if n != manifest["num_leaves"]:
        raise ValueError(f"checkpoint has {manifest['num_leaves']} leaves, template {n}")
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        tree = _rebuild(lambda key, like: _from_numpy(data[key], like, device, key), template)
    return tree, step


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "MANIFEST.json")):
                best = max(best or -1, int(name.split("_")[1]))
    return best


class CheckpointManager:
    """keep-k retention + async background saves + resume.

    ``saves`` records each completed save: its step, whether it was async,
    the ms the caller was blocked taking the snapshot, and the seconds the
    write took (on the writer thread for an async save)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._buffers: dict[str, torch.Tensor] = {}
        self.saves: list[dict] = []

    # -- snapshot -----------------------------------------------------------
    def _buffer(self, key: str, t: torch.Tensor) -> torch.Tensor:
        buf = self._buffers.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            self._buffers[key] = buf
        return buf

    def _snapshot(self, tree):
        """-> ({key: host tensor or numpy array}, the events to wait on).  Device
        tensors are copied into this manager's pinned buffers without blocking,
        host tensors into its buffers at once; the caller may then mutate the
        tree.  Only call after ``wait()``: the buffers are the last save's."""
        host, devices = {}, set()
        for key, leaf in _flatten(tree):
            if isinstance(leaf, torch.Tensor):
                buf = self._buffer(key, leaf)
                buf.copy_(leaf.detach(), non_blocking=leaf.is_cuda)
                if leaf.is_cuda:
                    devices.add(leaf.device)
                host[key] = buf
            else:
                host[key] = np.array(leaf)
        events = []
        for dev in devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
        return host, events

    def _write_snapshot(self, host, events, step: int, async_: bool,
                        snapshot_ms: float) -> None:
        t0 = time.perf_counter()
        for ev in events:
            ev.synchronize()
        _write({k: _to_numpy(v) for k, v in host.items()}, self.directory, step)
        self._gc()
        self.saves.append({"step": step, "async": async_, "snapshot_ms": snapshot_ms,
                           "write_s": time.perf_counter() - t0})

    # -- save ---------------------------------------------------------------
    def save(self, tree, step: int) -> None:
        self.wait()
        t0 = time.perf_counter()
        host, events = self._snapshot(tree)
        self._write_snapshot(host, events, step, False, (time.perf_counter() - t0) * 1e3)

    def async_save(self, tree, step: int) -> None:
        self.wait()
        t0 = time.perf_counter()
        host, events = self._snapshot(tree)  # before returning: the caller mutates the tree
        snapshot_ms = (time.perf_counter() - t0) * 1e3

        def run():
            try:
                self._write_snapshot(host, events, step, True, snapshot_ms)
            except BaseException as e:
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ------------------------------------------------------------
    def latest_step(self) -> int | None:
        return latest_step(self.directory)

    def restore(self, template, step: int | None = None, *, device=None):
        return restore_pytree(template, self.directory, step, device=device)

    # -- retention ----------------------------------------------------------
    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
