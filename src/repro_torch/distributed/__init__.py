"""Partition specs as plain data (``sharding``)."""

from .sharding import PartitionSpec, batch_axes

__all__ = ["PartitionSpec", "batch_axes"]
