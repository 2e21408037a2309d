"""Analytic cost of a traced step, for roofline analysis.

Counterpart of ``repro/core/costmodel.py``'s ``jaxpr_flops_bytes`` (:162):
``graph_flops_bytes(gm)`` walks an aten graph (``core.trace.capture_graph``)
with exact matrix-product math.  FLOPs are exact for matmul-dominated
models; bytes are the *unfused* upper bound (every node's operands and
results), which brackets device-memory traffic from above; ``bytes_fused``
charges only the nodes that must round-trip device memory (matrix products,
gathers, scatters, concatenations, the port's kernels), the estimate of the
reference's fusion-aware term.  The graph has no loops (every layer is
traced), so nothing is multiplied by a trip count and ``dynamic_loops`` is
0.  The reference's ``loop_aware_collectives``, a parser of the HLO
text of a compiled sharded step, waits for ROADMAP A12c's remaining piece.

The counts follow the reference's rules for its primitives: a product 2·out·K,
a reduction its input's elements, a transcendental 4 a result, data
movement 0, anything else one a result; the flash operators 4·B·H·hd
(forward) or 10·B·H·hd (backward) for each live (query, key) pair.
"""

from __future__ import annotations

from collections import defaultdict

from .trace import _REDUCTIONS, _is_tensor, _product_flops, _qualified, _tensor_args, \
    _tensor_bytes

_TRANSCENDENTAL = {"aten::" + n for n in ("exp", "log", "tanh", "sigmoid", "erf", "rsqrt",
                                          "sqrt", "sin", "cos", "pow", "log1p", "expm1",
                                          "silu", "logsumexp")}
_MOVEMENT = {"aten::" + n for n in (
    "gather", "scatter", "scatter_add", "index", "index_put", "index_select", "embedding",
    "slice", "select", "view", "_unsafe_view", "reshape", "permute", "transpose", "t",
    "expand", "squeeze", "unsqueeze", "_to_copy", "clone", "copy_", "cat", "constant_pad_nd",
    "arange", "zeros", "ones", "full", "empty", "new_zeros", "new_empty", "zeros_like",
    "ones_like", "full_like", "scalar_tensor", "alias", "detach", "lift_fresh_copy",
    "slice_backward", "select_backward", "flip")}
# Nodes that round-trip device memory whatever fuses around them.
_HEAVY = {"aten::" + n for n in (
    "mm", "bmm", "addmm", "baddbmm", "convolution", "gather", "scatter", "scatter_add",
    "index", "index_put", "index_select", "embedding", "embedding_dense_backward", "sort",
    "cat", "cumsum", "flip")}


def _node_flops(node) -> float:
    qual = _qualified(node)
    val = node.meta.get("val")
    outs = [v for v in (val if isinstance(val, (list, tuple)) else [val]) if _is_tensor(v)]
    out_elems = float(sum(int(v.numel()) for v in outs))
    flops = _product_flops(node, qual, out_elems)
    if flops is not None:
        return flops
    if qual in _REDUCTIONS:
        return float(sum(int(a.meta["val"].numel()) for a in _tensor_args(node)))
    if qual in _TRANSCENDENTAL:
        return 4.0 * out_elems
    if qual in _MOVEMENT:
        return 0.0
    return out_elems


def _node_bytes(node) -> float:
    val = node.meta.get("val")
    outs = [v for v in (val if isinstance(val, (list, tuple)) else [val]) if _is_tensor(v)]
    return float(sum(_tensor_bytes(v) for v in outs)
                 + sum(_tensor_bytes(a.meta["val"]) for a in _tensor_args(node)))


def graph_flops_bytes(gm, ops=None) -> dict:
    """Whole-graph analytic {flops, bytes, bytes_fused, dynamic_loops}; with
    ``ops`` (qualified names such as ``"aten::mm"``), of those nodes only."""
    acc = defaultdict(float)
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        qual = _qualified(node)
        if not qual or ops is not None and qual not in ops:
            continue
        acc["flops"] += _node_flops(node)
        acc["bytes"] += _node_bytes(node)
        if qual in _HEAVY or qual.startswith("repro_torch::") and qual != "repro_torch::label":
            acc["bytes_fused"] += _node_bytes(node)
    return {"flops": acc["flops"], "bytes": acc["bytes"], "bytes_fused": acc["bytes_fused"],
            "dynamic_loops": 0}
