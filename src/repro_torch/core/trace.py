"""Trace acquisition: the paper's Device abstraction and a graph tracer.

Counterpart of ``repro/core/trace.py``.  Two ways to obtain the event
stream the planner needs:

1. ``RecordingDevice`` — the paper's §V ``Device`` class, the reference's
   code (:54-118; ``tests/test_torch_solvers.py`` holds the two equal):
   ``Malloc``/``Free``/``Exec(fn, read_blocks, write_blocks)`` record events
   into a list which undergoes the repeatability test (core/iteration.py).
   The runtime path: model-transparent, no graph needed.

2. ``trace_step_fn`` / ``trace_graph`` — the counterparts of the
   reference's ``trace_step_fn`` / ``trace_jaxpr``.  ``trace_step_fn``
   traces a step function on fake tensors into an aten graph
   (``make_fx(..., tracing_mode="fake")``): no device memory is touched and
   nothing is launched, and fake CUDA tensors trace on a host without a
   card.  The port's kernels are ``torch.library`` operators with fake
   implementations (``kernels/ops.py``), so each is one node, as each
   ``pallas_call`` is one eqn.  ``trace_graph`` walks the graph as the
   reference walks a jaxpr: inputs are MALLOCed first, named by their
   pytree path (or ``arg_names``); each node READs its tensor inputs, then
   MALLOCs and WRITEs each new output; the outputs are READ once at the
   end; ``_with_frees`` (the reference's, as it is) puts each FREE after
   its variable's last use.

Unlike the reference, a variable is physical storage.  An output that the
op's schema declares an alias of an input (a view, a reshape that needs no
copy, ``detach``, ``expand``, ``t``) is no new variable: later uses read
the base's, so they extend its lifetime.  An in-place or ``out=`` op
(schema alias with a write) WRITEs its target and MALLOCs nothing.  A
``repro_torch::label`` node (``ops.label``, the reference's
``checkpoint_name``) READs the variable it marks, which ends there, and
starts a variable of the label's name over the same storage, which every
later use of that storage reads; like the reference's ``name`` eqn, it
never adds to the load, since the variable it ends is freed before the
one it starts is MALLOCed.  A tensor of 0 bytes is no variable: it gets
no event, and a node whose outputs are all such tensors is skipped, so
the trace of a step does not depend on how many of them the torch
version's ``checkpoint`` makes.

What the graph cannot see: memory a kernel allocates inside its wrapper
(the RMSNorm backward's fp32 ``partial`` rows, one wave of blocks × D × 4 B,
``kernels/rmsnorm.py``; the flash backward's fp32 ``delta`` [B, H, Sq]; the
tc SSD's C Bᵀ scratch; the SSD backward's chunk states and per-head dB, dC
in fp32) and the caching allocator's rounding; and the
reference's own constructs: the port has no scans, so every layer is
traced (``max_scan_unroll`` is accepted, so callers match, and has no
effect), and it writes no per-trip copies of scanned weights.

``op_costs`` holds (FLOPs, bytes) of each node, charged at its first
output's MALLOC (or its in-place WRITE): ``mm``/``addmm``/``bmm``/
``baddbmm`` 2·out·K; ``convolution`` 2·out·(cin·kh·kw);
``convolution_backward`` the two products the reference's jaxpr spells as
two ``conv_general_dilated`` eqns, 2·|x|·(kh·kw·cout) for grad_input and
2·|w|·(B·H'·W') for grad_weight, plus dy's elements for grad_bias, each
only where ``output_mask`` asks for it; the flash operators 4·B·H·hd
(forward) or 10·B·H·hd (backward) for each live (query, key) pair under
the node's own ``causal`` and ``window`` arguments, as ``chip_smoke.py``
counts them; the SSD scan and its backward by their
chunking's count (``kernels/ssd_scan.py`` ``flops``, ``bwd_flops``);
reductions their input's elements; any other op its output's elements,
as the reference's ``_eqn_cost``.  Bytes
are the node's tensor inputs and outputs.  The timing model prices swaps
with them; they are no measurement.
"""

from __future__ import annotations

from dataclasses import dataclass
import math
from typing import Any, Callable, Sequence

from .events import Event, EventKind, IterationTrace, build_trace
from .iteration import IterationDetector


@dataclass(frozen=True)
class Block:
    """Handle for a device memory block (the paper's ``Block*``)."""

    var: int
    size: int


class RecordingDevice:
    """Paper §V ``Device``: records Malloc/Free/Exec and detects the iteration.

    In the paper this object fronts cudaMalloc/cudaFree until the pool is
    built.  Here it fronts nothing (we are planning, not allocating) but the
    recorded stream and the repeatability test are identical.
    """

    def __init__(self, min_period: int = 4):
        self._next_var = 0
        self._index = 0
        self._detector = IterationDetector(min_period=min_period)
        self.events: list[Event] = []

    # -- paper API ----------------------------------------------------------
    def malloc(self, size: int) -> Block:
        blk = Block(self._next_var, int(size))
        self._next_var += 1
        self._emit(EventKind.MALLOC, blk)
        return blk

    def free(self, blk: Block) -> None:
        self._emit(EventKind.FREE, blk)

    def exec(
        self,
        fn: Callable[..., Any] | None,
        read_blocks: Sequence[Block],
        write_blocks: Sequence[Block],
        *args: Any,
    ) -> Any:
        """Run an operation, recording its read/write sets (paper's ``Exec``)."""
        for blk in read_blocks:
            self._emit(EventKind.READ, blk)
        for blk in write_blocks:
            self._emit(EventKind.WRITE, blk)
        return fn(*args) if fn is not None else None

    # -- stream plumbing -----------------------------------------------------
    def _emit(self, kind: EventKind, blk: Block) -> None:
        ev = Event(kind, blk.var, blk.size, self._index)
        self._index += 1
        self.events.append(ev)
        self._detector.feed(ev)

    @property
    def iteration_detected(self) -> bool:
        return self._detector.period is not None

    def iteration_trace(self) -> IterationTrace:
        """The canonical one-iteration trace (PoolOpt's input)."""
        self._detector.finalize()
        return build_trace(self._detector.iteration_events())


# --------------------------------------------------------------------------
# 2. graph-level lifetime extraction (the torch counterpart of the jaxpr walk)
# --------------------------------------------------------------------------

# The reference unrolls at most this many trips of a scan.  The port has no
# scans, so it has no effect; it is kept so that callers match.
_MAX_SCAN_UNROLL = 64

LABEL_OP = "repro_torch::label"
_MATMULS = {"aten::mm": 0, "aten::bmm": 0, "aten::addmm": 1, "aten::baddbmm": 1}
_REDUCTIONS = {"aten::sum", "aten::mean", "aten::amax", "aten::amin", "aten::max", "aten::min",
               "aten::argmax", "aten::argmin", "aten::prod", "aten::logsumexp"}
_FLASH = {"repro_torch::flash_attention": 4, "repro_torch::flash_attention_lse": 4,
          "repro_torch::flash_attention_bwd": 10}
# The SSD operators by their chunking's count (the functions of
# kernels/ssd_scan.py), from x [b, s, h, p] and Bm [b, s, g, n].
_SSD = {"repro_torch::ssd_scan": "flops", "repro_torch::ssd_scan_bwd": "bwd_flops"}


def _is_tensor(val) -> bool:
    return hasattr(val, "dtype") and hasattr(val, "numel") and hasattr(val, "shape")


def _tensor_bytes(val) -> int:
    return int(val.numel()) * int(val.element_size())


def _qualified(node) -> str:
    """``aten::mm``, ``repro_torch::rmsnorm``, or "" for a non-op node."""
    schema = getattr(node.target, "_schema", None)
    return schema.name if schema is not None else ""


def _short_name(node) -> str:
    qual = _qualified(node)
    return qual.split("::", 1)[1] if qual else str(getattr(node.target, "__name__", node.target))


def _tensor_args(node) -> list:
    """The fx nodes of ``node``'s tensor arguments, in order, one for each
    occurrence (lists flattened), as the reference reads each invar."""
    import torch.fx

    out: list = []

    def visit(a):
        if isinstance(a, torch.fx.Node):
            if _is_tensor(a.meta.get("val")):
                out.append(a)
        elif isinstance(a, (list, tuple)):
            for b in a:
                visit(b)

    for a in node.args:
        visit(a)
    for a in node.kwargs.values():
        visit(a)
    return out


def _live_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs a flash kernel computes: ``chip_smoke.live_pairs``."""
    total = 0
    for i in range(sq):
        hi = min(i + 1, sk) if causal else sk
        lo = max(0, i - window + 1) if window is not None else 0
        total += max(0, hi - lo)
    return total


def _product_flops(node, qual: str, out_elems: float) -> float | None:
    """FLOPs of a matrix product, a convolution or a flash operator, exact
    from the shapes (live pairs only for flash); None for any other node."""
    if qual in _MATMULS:
        return 2.0 * out_elems * float(node.args[_MATMULS[qual]].meta["val"].shape[-1])
    if qual == "aten::convolution":
        return 2.0 * out_elems * float(math.prod(node.args[1].meta["val"].shape[1:]))
    if qual == "aten::convolution_backward":
        return _conv_backward_flops(node)
    if qual in _SSD:
        from ..kernels import ssd_scan  # imports torch, which the graph's nodes hold already

        b, sq, h, p = node.args[0].meta["val"].shape
        n = node.args[3].meta["val"].shape[3]
        return float(getattr(ssd_scan, _SSD[qual])(b, sq, h, p, n))
    if qual in _FLASH:
        q, k = node.args[0].meta["val"], node.args[1].meta["val"]
        B, sq, H, hd = q.shape
        # Either kind's (causal, window): the forward's are its args 3 and 4,
        # the backward's (q, k, v, o, do, lse first) its args 6 and 7.
        at = 6 if qual.endswith("_bwd") else 3
        causal, window = node.args[at], node.args[at + 1]
        return float(_FLASH[qual] * B * H * hd * _live_pairs(sq, k.shape[1], causal, window))
    return None


def _conv_backward_flops(node) -> float:
    """A convolution's backward, priced as the products that the
    reference's jaxpr spells as ``conv_general_dilated`` eqns: grad_input,
    the transposed convolution, 2 · |x| · (kh·kw·cout/groups); grad_weight,
    a convolution of x with dy, 2 · |w| · (B·H'·W'); grad_bias a reduction
    of dy.  ``output_mask`` says which of the three the node computes (the
    first layer's computes no grad_input).  The reference's ``_eqn_cost``
    reads grad_input's eqn as kh·kw·cin (ROADMAP queue C)."""
    dy, x, w = (node.args[i].meta["val"] for i in range(3))
    groups, mask = node.args[9], node.args[10]
    flops = 0.0
    if mask[0]:
        flops += 2.0 * x.numel() * math.prod(w.shape[2:]) * (w.shape[0] // groups)
    if mask[1]:
        flops += 2.0 * w.numel() * dy.shape[0] * math.prod(dy.shape[2:])
    if mask[2]:
        flops += float(dy.numel())
    return flops


def _node_cost(node) -> tuple[float, float]:
    """Rough (flops, bytes_touched) of one graph node: the counterpart of the
    reference's ``_eqn_cost``, for the swap-schedule timing model only."""
    val = node.meta.get("val")
    outs = [v for v in (val if isinstance(val, (list, tuple)) else [val]) if _is_tensor(v)]
    ins = [a.meta["val"] for a in _tensor_args(node)]
    out_elems = float(sum(int(v.numel()) for v in outs))
    nbytes = float(sum(_tensor_bytes(v) for v in outs) + sum(_tensor_bytes(v) for v in ins))
    qual = _qualified(node)
    flops = _product_flops(node, qual, out_elems)
    if flops is None:
        flops = float(ins[0].numel()) if qual in _REDUCTIONS and ins else out_elems
    return (flops, nbytes)


def _alias_map(node) -> dict[int, tuple[Any, bool]]:
    """Output position -> (the argument node it aliases, whether the op
    writes it), from the op schema's alias annotations."""
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return {}
    by_set: dict = {}
    for i, arg in enumerate(schema.arguments):
        info = arg.alias_info
        if info is None:
            continue
        value = node.args[i] if i < len(node.args) else node.kwargs.get(arg.name)
        for s in info.before_set:
            by_set[s] = value
    out: dict[int, tuple[Any, bool]] = {}
    for j, ret in enumerate(schema.returns):
        info = ret.alias_info
        if info is None:
            continue
        for s in info.before_set:
            if s in by_set:
                out[j] = (by_set[s], info.is_write)
                break
    return out


def _holds_bytes(val) -> bool:
    """Whether ``val`` is a tensor with at least one element.  A 0-byte
    tensor gets no variable and no event: it holds no memory, and torch
    versions differ in how many they make (``torch.utils.checkpoint``
    makes two 0-element ``empty`` tensors a call in some versions, none in
    others), which would otherwise shift every later event's index and so
    the plan."""
    return _is_tensor(val) and _tensor_bytes(val) > 0


class _GraphEventEmitter:
    """Walks an fx graph of aten ops and emits the event stream: the
    counterpart of the reference's ``_JaxprEventEmitter``."""

    def __init__(self):
        self.events: list[Event] = []
        self.names: dict[int, str] = {}
        self.sizes: dict[int, int] = {}
        self.op_costs: dict[int, tuple[float, float]] = {}  # index -> (flops, bytes)
        self._index = 0
        self._next_var = 0
        self._renamed: dict[int, int] = {}  # a labelled variable -> the one it became

    def _fresh(self, size: int, name: str = "") -> int:
        vid = self._next_var
        self._next_var += 1
        self.sizes[vid] = size
        if name:
            self.names[vid] = name
        return vid

    def _emit(self, kind: EventKind, vid: int) -> None:
        self.events.append(Event(kind, vid, self.sizes[vid], self._index))
        self._index += 1

    def _var(self, env, node):
        """The variable that holds ``node``'s storage now (after labels)."""
        vid = env.get(node)
        while vid in self._renamed:
            vid = self._renamed[vid]
        return vid

    def run(self, gm, arg_names: Sequence[str]) -> None:
        env: dict[Any, Any] = {}  # fx node -> var id, or a list of them (tuple outputs)
        nodes = list(gm.graph.nodes)
        placeholders = [n for n in nodes if n.op == "placeholder"]
        for i, node in enumerate(placeholders):
            val = node.meta.get("val")
            if not _holds_bytes(val):
                continue
            name = arg_names[i] if i < len(arg_names) else f"arg{i}"
            env[node] = self._fresh(_tensor_bytes(val), name)
            self._emit(EventKind.MALLOC, env[node])
        for node in nodes:  # constants the graph holds (``get_attr``)
            if node.op == "get_attr" and _holds_bytes(node.meta.get("val")):
                env[node] = self._fresh(_tensor_bytes(node.meta["val"]), "const")
                self._emit(EventKind.MALLOC, env[node])
        for node in nodes:
            if node.op == "call_function":
                self._run_node(node, env)
            elif node.op == "output":
                for out in _tensor_args(node):
                    vid = self._var(env, out)
                    if vid is not None:
                        self._emit(EventKind.READ, vid)

    def _run_node(self, node, env) -> None:
        import operator

        if node.target is operator.getitem:  # one element of a tuple output
            parent = env.get(node.args[0])
            if isinstance(parent, list):
                env[node] = parent[node.args[1]]
            return
        val = node.meta.get("val")
        outs = list(val) if isinstance(val, (list, tuple)) else [val]
        if not any(_holds_bytes(v) for v in outs):
            return
        qual = _qualified(node)
        inputs = [self._var(env, a) for a in _tensor_args(node)]
        aliases = _alias_map(node)
        if qual == LABEL_OP:
            base = inputs[0]
            self._emit(EventKind.READ, base)
            vid = self._fresh(self.sizes[base], str(node.args[1]))
            self._renamed[base] = vid
            self.op_costs[self._index] = _node_cost(node)  # as the reference's name eqn
            self._emit(EventKind.MALLOC, vid)
            self._emit(EventKind.WRITE, vid)
            env[node] = vid
            return
        tensor_outs = [j for j, out in enumerate(outs) if _holds_bytes(out)]
        if all(j in aliases and not aliases[j][1] for j in tensor_outs):
            # A view of its input: no work, no new storage.
            ids = [env.get(aliases[j][0]) if j in aliases else None for j in range(len(outs))]
            env[node] = ids if isinstance(val, (list, tuple)) else ids[0]
            return
        for vid in inputs:
            if vid is not None:
                self._emit(EventKind.READ, vid)
        cost_index = self._index  # charged to the first output (or write)
        ids: list = []
        for j, out in enumerate(outs):
            if not _holds_bytes(out):
                ids.append(None)
                continue
            if j in aliases:
                target = env.get(aliases[j][0])
                if aliases[j][1] and target is not None:
                    self._emit(EventKind.WRITE, self._var(env, aliases[j][0]))
                ids.append(target)
                continue
            vid = self._fresh(_tensor_bytes(out), _short_name(node))
            self._emit(EventKind.MALLOC, vid)
            self._emit(EventKind.WRITE, vid)
            ids.append(vid)
        env[node] = ids if isinstance(val, (list, tuple)) else ids[0]
        self.op_costs[cost_index] = _node_cost(node)


def _leaf_paths(example_args) -> list[str]:
    """``arg0['blocks'][3]['attn']['wq']``-style names of the leaves, in the
    order ``make_fx`` makes them placeholders."""
    from torch.utils._pytree import keystr, tree_flatten_with_path

    leaves, _ = tree_flatten_with_path(tuple(example_args))
    return [f"arg{path[0].idx}{keystr(path[1:])}" for path, _ in leaves]


def capture_graph(fn: Callable, *example_args, device=None):
    """``fn`` traced at ``example_args`` (pytrees of real, fake or meta
    tensors) into an aten ``GraphModule`` on fake tensors.  Real tensors
    keep their device; meta tensors become fake tensors on ``device``,
    keeping their ``requires_grad``: by default ``"cuda"`` where CUDA is
    available, else ``"cpu"``, whose graph is the same (the operators'
    fake implementations do not depend on the device).  On a host without
    CUDA, ``device="cuda"`` traces forward functions only.  Nothing is
    allocated on any device and nothing is launched.  An op without a fake
    implementation raises, naming it."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils._pytree import tree_leaves, tree_map

    fakes = [a for a in tree_leaves(example_args) if isinstance(a, FakeTensor)]
    mode = fakes[0].fake_mode if fakes else FakeTensorMode()
    dev = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))

    def to_fake(a):
        if not isinstance(a, torch.Tensor) or isinstance(a, FakeTensor):
            return a
        if a.device.type == "meta":
            with mode:
                t = torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device=dev)
            return t.requires_grad_(a.requires_grad)
        return mode.from_tensor(a)

    traced = fn
    if dev.type == "cuda" and not torch.cuda.is_available():
        def traced(*args):
            with _indexing_without_cuda():
                return fn(*args)
    return make_fx(traced, tracing_mode="fake")(*tree_map(to_fake, tuple(example_args)))


def _getitem(t, index):
    """``t[index]`` for ints, slices, None, Ellipsis and one index tensor,
    through the aten ops Python indexing dispatches to."""
    import torch

    items = index if isinstance(index, tuple) else (index,)
    specified = sum(1 for i in items if i is not None and i is not Ellipsis)
    out, dim, advanced = t, 0, []
    for i in items:
        if i is Ellipsis:
            dim += t.ndim - specified
        elif i is None:
            out = out.unsqueeze(dim)
            dim += 1
        elif isinstance(i, bool) or isinstance(i, torch.Tensor) and i.dtype == torch.bool:
            raise NotImplementedError("boolean indexing of a fake CUDA tensor on a host "
                                      "without CUDA")
        elif isinstance(i, int):
            out = out.select(dim, i)
        elif isinstance(i, slice):
            if i != slice(None):
                out = torch.ops.aten.slice.Tensor(out, dim, i.start, i.stop, i.step or 1)
            dim += 1
        elif isinstance(i, torch.Tensor):
            advanced.append((dim, i))
            dim += 1
        else:
            raise NotImplementedError(f"index {i!r} of a fake CUDA tensor on a host without "
                                      f"CUDA")
    if advanced:
        spots = [None] * (max(d for d, _ in advanced) + 1)
        for d, i in advanced:
            spots[d] = i
        out = torch.ops.aten.index.Tensor(out, spots)
    return out


def _indexing_without_cuda():
    """A torch function mode for tracing fake CUDA tensors on a host built
    without CUDA.  There, Python indexing of a CUDA tensor asks for a CUDA
    device guard the host lacks, though no op needs one: the mode spells
    such indexing with the aten ops that indexing dispatches to
    (``slice``, ``select``, ``unsqueeze``, ``index``), so the graph is the
    one a CUDA host traces.  The autograd engine runs a CUDA tensor's
    backward on a device thread that needs the guard and aborts the
    process, so a gradient raises instead."""
    import torch
    from torch.overrides import TorchFunctionMode

    class IndexingWithoutCuda(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.__getitem__ and args[0].device.type == "cuda":
                return _getitem(*args)
            if func in (torch.autograd.grad, torch.Tensor.backward):
                raise NotImplementedError(
                    "a gradient of fake CUDA tensors needs a host with CUDA; trace on "
                    "device='cpu', whose graph is the same")
            return func(*args, **(kwargs or {}))

    return IndexingWithoutCuda()


def trace_step_fn(
    fn: Callable,
    *example_args,
    arg_names: Sequence[str] | None = None,
    max_scan_unroll: int = _MAX_SCAN_UNROLL,
    device=None,
) -> IterationTrace:
    """Trace ``fn`` at the given args (pytrees of real, fake or meta
    tensors; meta ones stand on ``device``, see ``capture_graph``) and
    return the one-iteration offline-DSA instance.

    FREE events are synthesized at last-use (refcount semantics), matching
    what the paper's runtime recorder observes from the framework's GC.
    ``max_scan_unroll`` has no effect (the port has no scans)."""
    gm = capture_graph(fn, *example_args, device=device)
    names = _leaf_paths(example_args)
    if arg_names:
        names[:len(arg_names)] = list(arg_names)[:len(names)]
    return trace_graph(gm, arg_names=names, max_scan_unroll=max_scan_unroll)


def trace_graph(
    gm,
    arg_names: Sequence[str] | None = None,
    max_scan_unroll: int = _MAX_SCAN_UNROLL,
) -> IterationTrace:
    """The event stream of an aten graph (``capture_graph``'s), with FREEs
    at last use, per-node costs and variable names: the counterpart of the
    reference's ``trace_jaxpr``."""
    em = _GraphEventEmitter()
    em.run(gm, list(arg_names or ()))
    events, index_map = _with_frees(em.events)
    trace = build_trace(events)
    trace.op_costs = {
        index_map[i]: cost for i, cost in em.op_costs.items() if i in index_map
    }
    info_by_id = trace.by_id()
    for vid, name in em.names.items():
        if vid in info_by_id:
            info_by_id[vid].name = name
    return trace


def _with_frees(events: list[Event]) -> tuple[list[Event], dict[int, int]]:
    """Insert FREE events at each variable's last use (refcounting).

    Returns the re-indexed stream plus a map old_index -> new_index so that
    per-op metadata (cost estimates) can follow the re-indexing.
    """
    last_use: dict[int, int] = {}
    size: dict[int, int] = {}
    for ev in events:
        last_use[ev.var] = ev.index
        size[ev.var] = ev.size
    # Re-index: frees occupy fresh op indices interleaved after last uses.
    by_index: dict[int, list[int]] = {}
    for var, idx in last_use.items():
        by_index.setdefault(idx, []).append(var)
    out: list[Event] = []
    index_map: dict[int, int] = {}
    cursor = 0
    for ev in events:
        index_map[ev.index] = cursor
        out.append(Event(ev.kind, ev.var, ev.size, cursor))
        cursor += 1
        for var in by_index.get(ev.index, ()):
            out.append(Event(EventKind.FREE, var, size[var], cursor))
            cursor += 1
    return out, index_map
