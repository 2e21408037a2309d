"""Sharded trace capture: per-device event streams from a partitioned step.

Counterpart of ``repro/dist/capture.py``.  The mesh as data (``MeshSpec``),
the shard divisors, the collectives' cost model, ``_synthesized``,
``sharded_param_bytes``, ``gradient_sync_collective`` and
``shard_existing_trace`` are the reference's code, with its imports
pointed into the port and its pytrees the port's (nested dicts, lists
and tuples, ``repro_torch.tree``, with ``distributed.PartitionSpec``
leaves); ``tests/test_torch_dist.py`` holds them equal.

The paper derives lifetimes and read/write order from the iterative loop
of a *single* device.  Under a sharded step each device owns a
*fraction* of every partitioned tensor and crosses the interconnect at
every collective, both of which the single-device tracer cannot see.
``capture_sharded_trace`` walks the aten graph the single-device tracer
walks (``core.trace.capture_graph``, on fake tensors), but

  * divides every variable's size by its *shard divisor*: an input's from
    its ``PartitionSpec`` (the ``launch/steps.py`` spec rules), keyed by
    the graph's placeholder index (a 0-byte input, which gets no
    variable, shifts no other input's divisor); a node's outputs take
    the largest divisor among its inputs, or 1 where that does not divide
    the output's bytes (the reference's rule); a view shares its base's
    variable and so its divisor, and a label's variable its base's; and
  * tags the ``_c10d_functional`` collectives (``COLLECTIVE_PRIMS``, the
    counterpart of the reference's jaxpr primitives) with cost-model
    durations on the device interconnect, over the devices of the node's
    process group; the ``wait_tensor`` that completes one is its output,
    no new variable.

On a 1x1 mesh every divisor is 1 and no collective fires, so the emitted
event stream, and therefore the solved plan, is byte-identical to the
single-device ``trace_graph`` path (``tests/test_torch_dist.py``).  Op
costs are the whole step's, as the reference's are.  The port's graphs
hold no scan (every layer is traced), so the reference's per-trip divisor
context for scanned weights (``_run_scan``, its ``:277``) has no
counterpart.

SPMD means every device executes the same program over same-shaped shards,
so one capture describes a whole *device group*; ``ShardedCapture`` keeps
the group->devices map explicit so heterogeneous groups (e.g. per-host
parameter servers) slot in without changing consumers.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field
from typing import Callable, Sequence

from ..core.events import EventKind, IterationTrace
from ..core.simulator import HardwareSpec
from ..core.trace import (
    LABEL_OP,
    _GraphEventEmitter,
    _holds_bytes,
    _qualified,
    _short_name,
    _tensor_args,
    _tensor_bytes,
    capture_graph,
    emitted_trace,
    input_names,
)
from ..distributed.sharding import PartitionSpec
from ..tree import tree_leaves

# Graph operators that cross the device interconnect: the functional
# collectives ``torch.distributed._functional_collectives`` records.
COLLECTIVE_PRIMS = {
    "_c10d_functional::all_reduce": "all_reduce",
    "_c10d_functional::all_gather_into_tensor": "all_gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce_scatter",
    "_c10d_functional::all_to_all_single": "all_to_all",
}
_WAIT = "_c10d_functional::wait_tensor"


# ------------------------------------------------------------------- meshes
@dataclass(frozen=True)
class MeshSpec:
    """Device-mesh shape as data: ordered (axis name, size) pairs.

    A plain-data mesh so planning and benchmarks never need real devices:
    the capture walks a graph of fake tensors and only the *sizes* matter.
    """

    axes: tuple[tuple[str, int], ...]

    @classmethod
    def make(cls, **axes: int) -> "MeshSpec":
        return cls(tuple((k, int(v)) for k, v in axes.items()))

    @classmethod
    def parse(cls, text: str) -> "MeshSpec":
        """Parse ``"data=4"`` / ``"data=4,model=2"`` (CLI mesh syntax)."""
        pairs = []
        for item in text.split(","):
            item = item.strip()
            if not item:
                continue
            name, _, size = item.partition("=")
            try:
                pairs.append((name.strip(), int(size)))
            except ValueError:
                raise ValueError(f"bad mesh axis {item!r} (want name=size)")
        if not pairs:
            raise ValueError(f"empty mesh spec {text!r}")
        return cls(tuple(pairs))

    @classmethod
    def from_mesh(cls, mesh) -> "MeshSpec":
        """From any mesh with ``axis_names`` and ``shape`` (a
        ``launch.shardplan.SpecMesh``, a ``DeviceMesh``-like object)."""
        return cls(tuple((str(n), int(mesh.shape[n])) for n in mesh.axis_names))

    @property
    def num_devices(self) -> int:
        n = 1
        for _, s in self.axes:
            n *= s
        return n

    def axis_size(self, names) -> int:
        """Product of the named axes' sizes (missing axes count as 1)."""
        if names is None:
            return 1
        if isinstance(names, str):
            names = (names,)
        sizes = dict(self.axes)
        n = 1
        for name in names:
            n *= sizes.get(name, 1)
        return n

    def signature(self) -> str:
        """Filesystem/key-safe mesh shape, empty for a single device so 1x1
        captures key identically to the legacy single-device path."""
        if self.num_devices <= 1:
            return ""
        return "x".join(f"{n}{s}" for n, s in self.axes)


def shard_divisor(shape: Sequence[int], spec, mesh: MeshSpec) -> int:
    """How many ways a tensor of ``shape`` is split under ``spec``.

    ``spec`` is a ``PartitionSpec``-like sequence: one entry per dim, each
    None, an axis name, or a tuple of axis names.  A dim that the mesh axes
    do not divide evenly degrades to replicated for that dim — matching the
    launch/steps.py divisibility guard.
    """
    div = 1
    for dim, part in zip(shape, spec):
        if part is None:
            continue
        k = mesh.axis_size(part)
        if k > 1 and dim % k == 0:
            div *= k
    return div


def _spec_leaves(specs) -> list:
    """The leaves of a spec tree in ``tree_leaves`` order, a spec (a tuple
    itself) or None being one leaf."""
    if specs is None or isinstance(specs, PartitionSpec):
        return [specs]
    if isinstance(specs, dict):
        return [leaf for v in specs.values() for leaf in _spec_leaves(v)]
    if isinstance(specs, (list, tuple)):
        return [leaf for v in specs for leaf in _spec_leaves(v)]
    raise TypeError(f"{type(specs).__name__} in a spec tree (want PartitionSpec or None)")


def divisors_from_specs(shapes, specs, mesh: MeshSpec) -> list[int]:
    """Per-leaf shard divisors for a tree of tensors (real, fake or meta)
    and its tree of specs, in ``tree_leaves`` order: the order ``make_fx``
    makes the leaves placeholders."""
    shape_leaves = tree_leaves(shapes)
    spec_leaves = _spec_leaves(specs)
    if len(shape_leaves) != len(spec_leaves):
        raise ValueError(
            f"{len(shape_leaves)} shape leaves vs {len(spec_leaves)} spec leaves"
        )
    out = []
    for leaf, spec in zip(shape_leaves, spec_leaves):
        if spec is None:
            out.append(1)
        else:
            out.append(shard_divisor(leaf.shape, spec, mesh))
    return out


# -------------------------------------------------------------- collectives
@dataclass(frozen=True)
class Collective:
    """One tagged interconnect operation within the iteration."""

    index: int          # op index in the per-device event stream
    kind: str           # canonical name (all_reduce / all_gather / ...)
    nbytes: int         # per-device payload bytes
    seconds: float      # modeled interconnect occupancy


def collective_seconds(kind: str, nbytes: int, ndev: int, hw: HardwareSpec) -> float:
    """Ring cost model: all-reduce moves 2(D-1)/D of the payload per device,
    gather/scatter (D-1)/D, permutes one hop."""
    if ndev <= 1 or nbytes <= 0:
        return 0.0
    bw = hw.ici_bw or hw.link_bw
    if kind == "all_reduce":
        factor = 2.0 * (ndev - 1) / ndev
    elif kind in ("all_gather", "reduce_scatter", "all_to_all"):
        factor = (ndev - 1) / ndev
    else:  # permute / broadcast: one hop
        factor = 1.0
    return factor * nbytes / bw + hw.collective_latency_s


# ------------------------------------------------------------------ capture
@dataclass
class ShardedTrace:
    """Per-device-group iteration trace plus its tagged collectives."""

    trace: IterationTrace
    collectives: list[Collective] = field(default_factory=list)

    def collective_map(self) -> dict[int, float]:
        """Op index -> seconds, the shape ``runtime.Tenant.collectives`` takes."""
        out: dict[int, float] = {}
        for c in self.collectives:
            out[c.index] = out.get(c.index, 0.0) + c.seconds
        return out


@dataclass
class ShardedCapture:
    """One sharded capture: the mesh, the per-group streams, and which
    devices run which group (SPMD: one group spanning every device)."""

    mesh: MeshSpec
    groups: dict[str, ShardedTrace]
    device_group: dict[int, str]
    spec_signature: str = ""

    def plan_topology(self) -> str:
        """The ``PlanKey.topology`` value: mesh shape + PartitionSpec
        signature.  Empty on a 1x1 mesh, so single-device plans keep their
        legacy keys (and a sharded plan can never alias one)."""
        mesh_sig = self.mesh.signature()
        if not mesh_sig:
            return ""
        return f"{mesh_sig}-{self.spec_signature}" if self.spec_signature else mesh_sig


class _ShardedGraphEmitter(_GraphEventEmitter):
    """The single-device graph walk, re-sized per shard.

    Every variable gets a *divisor*: inputs from their PartitionSpecs (by
    placeholder index), a node's outputs by propagation (the largest
    divisor among its inputs where it divides the output's bytes;
    otherwise replicated).  ``_fresh`` divides by ``_ctx_div``, the
    divisor of the input or node being walked."""

    def __init__(self, mesh: MeshSpec, hw: HardwareSpec, arg_divisors: Sequence[int]):
        super().__init__()
        self.mesh = mesh
        self.hw = hw
        self.divisors: dict[int, int] = {}
        self.collectives: list[Collective] = []
        self._ctx_div = 1
        self._arg_divs = list(arg_divisors)

    # -- sizing ---------------------------------------------------------
    def _fresh(self, size: int, name: str = "") -> int:
        div = self._ctx_div
        if div <= 1 or size <= 0 or size % div != 0:
            div = 1
        vid = super()._fresh(size // div, name)
        self.divisors[vid] = div
        return vid

    def _input(self, placeholder: int, size: int, name: str) -> int:
        self._ctx_div = self._arg_divs[placeholder] if self._arg_divs else 1
        try:
            return super()._input(placeholder, size, name)
        finally:
            self._ctx_div = 1

    # -- walking ----------------------------------------------------------
    def _run_node(self, node, env) -> None:
        qual = _qualified(node)
        inputs = [self._var(env, a) for a in _tensor_args(node)]
        div = max([1] + [self.divisors.get(v, 1) for v in inputs if v is not None])
        sharded = self.mesh.num_devices > 1
        if sharded and qual == _WAIT:  # the collective's own output, completed
            env[node] = env.get(node.args[0])
            return
        # A label's variable is its base's storage, already sized per device.
        self._ctx_div = 1 if qual == LABEL_OP else div
        try:
            if sharded and qual in COLLECTIVE_PRIMS:
                self._run_collective(node, env, inputs, COLLECTIVE_PRIMS[qual])
            else:
                super()._run_node(node, env)
        finally:
            self._ctx_div = 1
        if qual == LABEL_OP and isinstance(env.get(node), int):
            self.divisors[env[node]] = div

    def _run_collective(self, node, env, inputs, kind: str) -> None:
        """A collective reads its (per-shard) inputs, occupies the
        interconnect, and writes its outputs; the payload is the per-shard
        input bytes already divided by the sharding."""
        nbytes = sum(self.sizes[v] for v in inputs if v is not None)
        for vid in inputs:
            if vid is not None:
                self._emit(EventKind.READ, vid)
        cost_index = self._index  # charged to the first output, like compute
        val = node.meta.get("val")
        ids = []
        for out in (list(val) if isinstance(val, (list, tuple)) else [val]):
            if not _holds_bytes(out):
                ids.append(None)
                continue
            vid = self._fresh(_tensor_bytes(out), _short_name(node))
            self._emit(EventKind.MALLOC, vid)
            self._emit(EventKind.WRITE, vid)
            ids.append(vid)
        env[node] = ids if isinstance(val, (list, tuple)) else ids[0]
        ndev = _collective_device_count(node, self.mesh)
        seconds = collective_seconds(kind, nbytes, ndev, self.hw)
        if seconds > 0.0:
            self.collectives.append(Collective(cost_index, kind, nbytes, seconds))


def _collective_device_count(node, mesh: MeshSpec) -> int:
    """Devices taking part in a collective node: its ``group_size``
    argument, else the size of the process group it names, falling back
    to the whole mesh."""
    import torch.distributed as dist

    schema = node.target._schema
    args = {a.name: v for a, v in zip(schema.arguments, node.args)}
    args.update(node.kwargs)
    n = args.get("group_size")
    if n is None and dist.is_available():
        from torch.distributed.distributed_c10d import _resolve_process_group

        try:
            n = _resolve_process_group(args["group_name"]).size()
        except RuntimeError:  # no such group in this process
            n = None
    return n if n and n > 1 else mesh.num_devices


def _synthesized(
    extra: Sequence[tuple], trace: IterationTrace, mesh: MeshSpec, hw: HardwareSpec
) -> list[Collective]:
    """Cost-model collectives a graph without collective nodes cannot show
    (a data-parallel step whose gradient sync runs outside the traced
    function), so callers name the known ones.  Entries are
    ``(kind, nbytes[, op_index[, ndev]])``: op_index defaults to the
    iteration boundary (the data-parallel gradient sync position; None also
    means that), a float in [0, 1) is a fraction of the iteration (op counts
    aren't known pre-capture), and ``ndev`` scopes the collective to its
    participating axis (e.g. 4 for a data-axis all-reduce on a
    data=4,model=2 mesh) instead of the whole mesh."""
    out: list[Collective] = []
    tail = max(0, trace.num_indices - 1)
    for entry in extra:
        kind, nbytes = entry[0], int(entry[1])
        index = tail
        if len(entry) > 2 and entry[2] is not None:
            pos = entry[2]
            index = int(pos * tail) if isinstance(pos, float) and 0 <= pos < 1 else int(pos)
        index = max(0, min(index, tail))
        ndev = int(entry[3]) if len(entry) > 3 and entry[3] else mesh.num_devices
        seconds = collective_seconds(kind, nbytes, ndev, hw)
        if seconds > 0.0:
            out.append(Collective(index, kind, nbytes, seconds))
    return out


def sharded_param_bytes(shapes, specs, mesh: MeshSpec) -> int:
    """Per-device bytes of a (shapes, PartitionSpecs) tree pair — what one
    device holds of the parameters, i.e. its gradient-sync payload."""
    divs = divisors_from_specs(shapes, specs, mesh)
    leaves = tree_leaves(shapes)
    return sum(
        math.prod(leaf.shape) * leaf.dtype.itemsize // d
        for leaf, d in zip(leaves, divs)
    )


def gradient_sync_collective(
    pshapes, pspecs, mesh: MeshSpec, axes=("pod", "data")
) -> "tuple | None":
    """The data-parallel gradient all-reduce as an ``extra_collectives``
    entry (iteration boundary, scoped to the data axes), or None when the
    mesh has no data parallelism.  One definition shared by the shardplan
    CLI and the chip smoke so both price the same cost model."""
    ndev = mesh.axis_size(tuple(axes))
    if ndev <= 1:
        return None
    return ("all_reduce", sharded_param_bytes(pshapes, pspecs, mesh), None, ndev)


def _spec_signature_from_divisors(divisors: Sequence[int]) -> str:
    """Stable short hash of the per-input shard pattern: two captures of the
    same step under different PartitionSpecs must key differently."""
    raw = ",".join(str(d) for d in divisors)
    return hashlib.sha256(raw.encode()).hexdigest()[:8]


def capture_sharded_trace(
    fn: Callable,
    *example_args,
    mesh: MeshSpec,
    hw: HardwareSpec,
    in_specs=None,
    arg_names: Sequence[str] | None = None,
    extra_collectives: Sequence[tuple] = (),
    device=None,
) -> ShardedCapture:
    """Capture the per-device event stream of one sharded step.

    ``fn`` is traced at ``example_args`` (trees of real, fake or meta
    tensors; meta ones stand on ``device``) by ``core.trace.capture_graph``
    and the graph sharded by ``shard_graph``: nothing is allocated on any
    device, so a 4-way mesh plans on one host.
    """
    gm = capture_graph(fn, *example_args, device=device)
    return shard_graph(gm, example_args, mesh=mesh, hw=hw, in_specs=in_specs,
                       arg_names=arg_names, extra_collectives=extra_collectives)


def shard_graph(
    gm,
    example_args,
    *,
    mesh: MeshSpec,
    hw: HardwareSpec,
    in_specs=None,
    arg_names: Sequence[str] | None = None,
    extra_collectives: Sequence[tuple] = (),
) -> ShardedCapture:
    """The per-device event stream of a captured graph (``capture_graph``
    of a step at ``example_args``, whose leaves are its placeholders).

    ``in_specs`` is a tree of PartitionSpecs matching ``example_args``
    (the launch/steps.py rules produce exactly this), or None for fully
    replicated inputs.  ``extra_collectives`` appends cost-model
    collectives the graph does not contain explicitly — a data-parallel
    loss step holds no collective node, so callers name the known ones,
    e.g. ``[("all_reduce", grad_bytes)]`` for the gradient sync at the
    iteration boundary.  Inputs are named as ``trace_step_fn`` names them.
    """
    n_inputs = sum(1 for n in gm.graph.nodes if n.op == "placeholder")
    arg_divisors: list[int] = []
    if in_specs is not None:
        arg_divisors = divisors_from_specs(example_args, in_specs, mesh)
        if len(arg_divisors) != n_inputs:
            raise ValueError(f"{len(arg_divisors)} spec leaves for the graph's "
                             f"{n_inputs} inputs")
    em = _ShardedGraphEmitter(mesh, hw, arg_divisors)
    em.run(gm, input_names(example_args, arg_names))
    trace, index_map = emitted_trace(em)
    collectives = [
        Collective(index_map[c.index], c.kind, c.nbytes, c.seconds)
        for c in em.collectives
        if c.index in index_map
    ]
    collectives.extend(_synthesized(extra_collectives, trace, mesh, hw))
    if mesh.num_devices > 1 and collectives:
        trace.op_extra_s = {}
        for c in collectives:
            trace.op_extra_s[c.index] = trace.op_extra_s.get(c.index, 0.0) + c.seconds
    sharded = ShardedTrace(trace=trace, collectives=sorted(collectives, key=lambda c: c.index))
    spec_sig = (
        _spec_signature_from_divisors(arg_divisors)
        if arg_divisors and mesh.num_devices > 1
        else ""
    )
    return ShardedCapture(
        mesh=mesh,
        groups={"spmd": sharded},
        device_group={d: "spmd" for d in range(mesh.num_devices)},
        spec_signature=spec_sig,
    )


def shard_existing_trace(
    trace: IterationTrace,
    mesh: MeshSpec,
    hw: HardwareSpec,
    divisor_fn: Callable[[str, int], int],
    extra_collectives: Sequence[tuple[str, int]] = (),
) -> ShardedCapture:
    """Re-size an already-captured single-device trace by a per-variable
    divisor rule ``divisor_fn(name, size) -> int`` (e.g. batch-sharded
    activations / replicated weights for the CNN benchmark traces).

    The cheap route into ``repro_torch.dist`` for workloads whose trace
    exists but whose step function is not at hand; the graph route above is
    the faithful one.
    """
    variables = []
    applied: list[int] = []
    for v in trace.variables:
        div = max(1, int(divisor_fn(v.name, v.size)))
        if v.size % div != 0:
            div = 1
        applied.append(div)
        variables.append(
            type(v)(
                var=v.var,
                size=v.size // div,
                alloc_index=v.alloc_index,
                free_index=v.free_index,
                accesses=list(v.accesses),
                access_is_write=list(v.access_is_write),
                name=v.name,
            )
        )
    sharded = IterationTrace(variables, trace.num_indices)
    if trace.op_costs is not None:
        # Per-device compute touches per-device bytes; flops scale the same
        # way for batch-parallel work.
        ndev = mesh.num_devices
        sharded.op_costs = {
            i: (f / ndev, b / ndev) for i, (f, b) in trace.op_costs.items()
        }
    collectives = _synthesized(extra_collectives, sharded, mesh, hw)
    if collectives:
        sharded.op_extra_s = {}
        for c in collectives:
            sharded.op_extra_s[c.index] = sharded.op_extra_s.get(c.index, 0.0) + c.seconds
    return ShardedCapture(
        mesh=mesh,
        groups={"spmd": ShardedTrace(sharded, collectives)},
        device_group={d: "spmd" for d in range(mesh.num_devices)},
        # Signed by the divisors actually applied, so two different rules
        # (or an edited rule) over the same trace never share a PlanKey.
        spec_signature=f"rule{_spec_signature_from_divisors(applied)}",
    )
