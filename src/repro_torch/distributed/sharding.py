"""Partition specs as plain data: what the spec rules read.

Counterpart of the parts of ``repro/distributed/sharding.py`` that the
rules of ``launch/steps.py`` read: a ``PartitionSpec`` data type and
``batch_axes`` (the reference's ``:163``).  A spec names, for each dim of
a tensor, the mesh axes it is split over: ``None`` (replicated), an axis
name, or a tuple of names.  A mesh is any object with ``axis_names`` and
``shape`` (``launch.shardplan.SpecMesh``).

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model")
multi-pod; "pod" is an outer data-parallel axis.

The logical-axis rules (``use_mesh``, ``shard``, ``shard_pick``) constrain
tensors inside a sharded program; nothing in the port executes sharded yet
(ROADMAP A12d).
"""

from __future__ import annotations


class PartitionSpec(tuple):
    """One entry a dim: ``None``, a mesh axis name, or a tuple of names.

    A tuple, so it indexes, iterates and compares as one; a pytree walk
    that must stop at it says so (``dist.capture._spec_leaves``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):  # copy and pickle rebuild it from its entries
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
