"""Computation-graph visualization (the JAX package's
``utils/visualize.py``).

The reference renders the autograd graph with graphviz (reference:
visualize.py:8-55, vendored from functional-zoo). Here a function is
traced with ``torch.fx.experimental.proxy_tensor.make_fx``, which runs it
on the example tensors and records every aten op (the counterpart of
``jax.make_jaxpr``), and the graph is emitted as Graphviz dot text; plus a
compact parameter-tree summary. No graphviz runtime dependency: render the
dot source with any dot tool.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

_DTYPES = {torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
           torch.bfloat16: "bf16", torch.int8: "i8", torch.int16: "i16",
           torch.int32: "i32", torch.int64: "i64", torch.uint8: "u8",
           torch.bool: "bool"}


def _short(val) -> str:
    """``f32[2,3]`` for a tensor (jaxpr's short form); tuples element-wise."""
    if isinstance(val, (tuple, list)):
        return "(" + ", ".join(_short(v) for v in val) + ")"
    if isinstance(val, torch.Tensor):
        dims = ",".join(str(int(d)) for d in val.shape)
        return f"{_DTYPES.get(val.dtype, str(val.dtype))}[{dims}]"
    return type(val).__name__


def _op_name(target) -> str:
    packet = getattr(target, "overloadpacket", target)
    return getattr(packet, "__name__", str(target))


def make_dot(fn: Callable, *example_args, max_nodes: int = 400) -> str:
    """Trace ``fn`` on ``example_args`` (tensors, or trees of them) and
    return Graphviz dot source of its aten graph: green inputs, one box per
    op, a white node per value with its dtype and shape, edges along data
    flow, salmon outputs, and a ``trunc`` node past ``max_nodes`` ops.
    Analogue of the reference's ``make_dot(loss)`` autograd rendering (reference:
    visualize.py:8)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    graph = make_fx(fn)(*example_args).graph
    lines = [
        "digraph aten {",
        '  node [shape=box, style=filled, fillcolor="lightblue", fontsize=10];',
    ]
    names: dict[Any, str] = {}

    def nid(node) -> str:
        if node not in names:
            names[node] = f"v{len(names)}"
        return names[node]

    nodes = list(graph.nodes)
    inputs = [n for n in nodes if n.op == "placeholder"]
    ops = [n for n in nodes if n.op not in ("placeholder", "output")]
    outputs = [n for n in nodes if n.op == "output"]
    for i, node in enumerate(inputs):
        lines.append(
            f'  {nid(node)} [label="in{i}\\n{_short(node.meta.get("val"))}", '
            'fillcolor="palegreen"];')
    for i, node in enumerate(ops[:max_nodes]):
        eid = f"e{i}"
        lines.append(f'  {eid} [label="{_op_name(node.target)}"];')
        for src in node.all_input_nodes:
            if src in names:
                lines.append(f"  {nid(src)} -> {eid};")
        lines.append(f'  {nid(node)} [label="{_short(node.meta.get("val"))}", '
                     'fillcolor="white"];')
        lines.append(f"  {eid} -> {nid(node)};")
    if len(ops) > max_nodes:
        lines.append(f'  trunc [label="... {len(ops) - max_nodes} more ops"];')
    for out in outputs:
        for node in out.all_input_nodes:
            if node in names:
                lines.append(f'  {nid(node)} [fillcolor="lightsalmon"];')
    lines.append("}")
    return "\n".join(lines)


def _flatten_with_path(tree, path=()):
    """``(path, leaf)`` in JAX's flatten order: dict keys sorted, tuple and
    list entries by index."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten_with_path(tree[key], path + (key,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, path + (i,))
    elif tree is not None:
        yield path, tree


def param_summary(params: Any) -> str:
    """Human-readable parameter-tree table (analogue of printing the
    reference nn.Module, train_script.py:34-36); for the same weights the
    text equals the JAX package's ``param_summary``."""
    rows = []
    total = 0
    for path, leaf in _flatten_with_path(params):
        name = "/".join(str(p) for p in path)
        shape = tuple(int(d) for d in leaf.shape)
        n = 1
        for d in shape:
            n *= d
        total += n
        rows.append(f"  {name:<24} {str(shape):<20} {n:>10,}")
    header = f"{'parameter':<26} {'shape':<20} {'count':>10}"
    return "\n".join([header, *rows, f"  {'total':<24} {'':<20} {total:>10,}"])
